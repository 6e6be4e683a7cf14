"""The sharded steps hold no op that torch 2.11's DTensor refuses, on the
CPU with no spawned ranks.

torch 2.11's DTensor refuses a view that merges two sharded dims (or a
group of dims whose sharded dim is not its outermost), any op on a
`_StridedShard` placement, and a pad of a DTensor; later versions carry
them through `_StridedShard`, so a run on this torch cannot see the fault.
`launch.dryrun.CollectiveBytes` lists such ops as they dispatch
(`refused_sharding`). Here one pod's train, prefill and decode step of
each family run as meta DTensors over a placeholder process group
(`dryrun.count_step`) at smoke widths, two superblocks deep (the second
takes the sequence-parallel residual stream, which the first, fed by the
embedding, does not), B = 2 and S = 8, at (data 2, model 2), and for
musicgen-medium, llama3-8b and vision-90b at (data 2, model 4) too,
where their 6 heads or 2 kv heads do not divide the model axis (their
head dims are sharded). Every step must list none.

Also: the guard fires on each pattern it names and passes a merge whose
sharded dim is outermost, and `runtime.sharding.project` on plain
tensors is `torch.einsum` bit for bit (one product a weight).
"""

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry
from repro_torch.optim import adamw, cosine_lr
from repro_torch.runtime import sharding as sh

ARCHS = ["llama3-8b", "musicgen-medium", "deepseek-v2-236b",
         "llama-3.2-vision-90b", "zamba2-2.7b", "falcon-mamba-7b"]
LAYOUTS = {"data2-model2": (2, 2), "data2-model4": (2, 4)}
#: the archs whose smoke heads (or kv heads) do not divide model 4: their
#: head dims are sharded there (the others' layout is (2, 2)'s)
HEADS_APART = ["llama3-8b", "musicgen-medium", "llama-3.2-vision-90b"]
KINDS = ["train", "prefill", "decode"]
B, S = 2, 8


def _refused(arch: str, kind: str, layout) -> list:
    D, m = layout
    with dryrun.placeholder_group(D * m) as group:
        dm = DeviceMesh("cuda", torch.arange(D * m).reshape(D, m),
                        mesh_dim_names=("data", "model"))
        mesh = Mesh(("data", "model"), (D, m), torch.device("meta"), group,
                    dm)
        counted = dryrun.count_step(registry.get_config(arch, "smoke"),
                                    ShapeCell(kind, S, B, kind), mesh,
                                    adamw(cosine_lr(3e-4, 10)))
    return counted.refused


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch,layout", [
    (arch, "data2-model2") for arch in ARCHS] + [
    (arch, "data2-model4") for arch in HEADS_APART])
def test_sharded_step_holds_no_op_torch_2_11_refuses(arch, layout, kind):
    refused = _refused(arch, kind, LAYOUTS[layout])
    assert not refused, (len(refused), refused[:5])


def _placed(shape, placements, mesh):
    """A meta DTensor of global `shape` laid out by `placements`."""
    local = list(shape)
    for d, pl in enumerate(placements):
        if pl.is_shard():
            local[pl.dim] //= mesh.size(d)
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


@pytest.mark.parametrize("case", [
    "merge_two_shards", "merge_inner_shard", "strided_input", "pad",
    "merge_outer_shard", "split_shard"])
def test_guard_names_what_torch_2_11_refuses(case):
    """The three patterns are counted, each where it dispatches; a merge
    whose sharded dim is the group's outermost, and a split of a sharded
    dim, are not."""
    with dryrun.placeholder_group(4):
        mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        counted = dryrun.CollectiveBytes()
        with counted:
            if case == "merge_two_shards":   # the einsums' fault
                _placed((4, 8, 6), (Shard(0), Shard(1)), mesh).reshape(32, 6)
            elif case == "merge_inner_shard":  # musicgen's head-dim flatten
                _placed((6, 16, 4), (Replicate(), Shard(1)),
                        mesh).reshape(96, 4)
            elif case == "strided_input":
                from torch.distributed.tensor.placement_types import \
                    _StridedShard

                t = DTensor.from_local(
                    torch.empty((4, 6), device="meta"), mesh,
                    (Replicate(), _StridedShard(0, split_factor=2)),
                    run_check=False, shape=torch.Size((8, 6)), stride=(6, 1))
                try:
                    t + 1
                except Exception:  # noqa: BLE001 -- counted before it runs
                    pass
            elif case == "pad":              # the causal conv's F.pad
                torch.nn.functional.pad(
                    _placed((4, 8, 6), (Shard(0), Replicate()), mesh),
                    (0, 0, 3, 0))
            elif case == "merge_outer_shard":
                _placed((4, 8, 6), (Shard(0), Replicate()),
                        mesh).reshape(32, 6)
            else:
                _placed((4, 8, 6), (Shard(0), Shard(2)),
                        mesh).reshape(4, 8, 2, 3)
    want = 0 if case in ("merge_outer_shard", "split_shard") else 1
    assert len(counted.refused) == want, counted.refused


@pytest.mark.parametrize("eq,shapes", [
    ("bsd,dhk->bshk", [(2, 5, 12), (12, 3, 4)]),
    ("bshk,hkd->bsd", [(2, 5, 3, 4), (3, 4, 12)]),
    ("bsd,df->bsf", [(2, 5, 12), (12, 7)]),
    ("bhq,qhk->bhk", [(2, 3, 6), (6, 3, 4)]),
    ("bshk,qhk->bhq", [(2, 1, 3, 4), (6, 3, 4)]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_on_plain_tensors_is_einsum(eq, shapes, dtype):
    rng = np.random.default_rng(29)
    x, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        getattr(torch, dtype)) for s in shapes)
    got = sh.project(eq, x, w)
    assert got.dtype == x.dtype
    assert torch.equal(got, torch.einsum(eq, x, w))
    assert torch.equal(sh.project(eq, x, w, keep_weights=True), got)
    # several weights on one x: one product each
    got2 = sh.project(eq, x, w, 2 * w)
    assert isinstance(got2, tuple) and len(got2) == 2
    assert torch.equal(got2[0], got)
    assert torch.equal(got2[1], torch.einsum(eq, x, 2 * w))
