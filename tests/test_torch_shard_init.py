"""The shard-wise init, on the CPU without ranks: `launch.train.init_state`
on a sharded mesh draws each rank's shards alone (`draw_shards`,
`prng.truncated_normal(block=)`, `runtime.sharding.local_block`), and
every rank's shard equals the whole draw cut by `runtime.sharding.cut`.

Each rank is taken in turn in this process on torch's placeholder
process group (the "fake" backend: a DeviceMesh and its coordinates, no
communication), so `cut` and the DTensors stand as on a real rank.
Standards, all bit for bit:
  * a smoke arch of every family (dense, MoE and MLA, state-space,
    hybrid, VLM) on (data 2, model 2) and with two pods stacked on every
    rank: every rank's parameters and AdamW state equal the unsharded
    init's cut by the training placements, shapes, strides and
    placements included;
  * uneven shards (a dimension that does not divide its mesh dimension,
    an empty last piece, two mesh dimensions on one tensor dimension)
    come out as `distribute_tensor` cuts them, and a mesh whose data
    axis divides no dimension leaves those dimensions whole;
  * no tensor made during a rank's init has more elements than its
    largest local shard or a chunk of the draw (`prng._CHUNK`);
  * `prng.bits_at` of a non-contiguous block's indices, and
    `truncated_normal(block=)` over several chunks, equal the whole
    draw's elements.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.utils._pytree as _pytree
from torch.distributed.tensor import Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import optim
from repro_torch.compress import prng
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import _placement_leaves, draw_shards, init_state
from repro_torch.models import registry
from repro_torch.runtime import sharding as sh

AXES = ("pod", "data", "model")
#: a smoke arch of each family
ARCHS = ("llama3-8b", "deepseek-v2-236b", "falcon-mamba-7b", "zamba2-2.7b",
         "llama-3.2-vision-90b")
#: (mesh shape, ranks): one pod over data x model, two pods stacked on
#: every rank
LAYOUTS = {"data2_model2": ((1, 2, 2), 4), "pods_stacked": ((2, 2, 2), 4)}


@contextlib.contextmanager
def _rank(rank: int, world: int):
    """This process as `rank` of a placeholder group of `world` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits (bf16 and float32 alike), for exact comparison."""
    t = t.detach().contiguous().reshape(-1)
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()]
    return t.view(view).numpy()


def _same(ours, want, label: str) -> None:
    assert ours.shape == want.shape, label
    assert ours.stride() == want.stride(), label
    assert tuple(ours.placements) == tuple(want.placements), label
    np.testing.assert_array_equal(_bits(ours.to_local()),
                                  _bits(want.to_local()), err_msg=label)


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_draws_the_whole_draws_cut(arch, layout, one_thread):
    shape, world = LAYOUTS[layout]
    cfg = registry.get_config(arch, "smoke")
    opt = optim.adamw(optim.cosine_lr(3e-4, 6))
    whole, whole_state = init_state(cfg, opt, shape[0], 0, "cpu")
    for rank in range(world):
        with _rank(rank, world):
            mesh = make_mesh(shape, AXES, device="cpu",
                             group=dist.group.WORLD)
            params, state = init_state(cfg, opt, shape[0], 0, "cpu",
                                       mesh=mesh)
            p_pl, s_pl, _ = sp.train_placements(cfg, opt, mesh, (1, 1))
            dm = mesh.shard_mesh
            for i, (ours, w, pl) in enumerate(zip(
                    _pytree.tree_leaves(params), _pytree.tree_leaves(whole),
                    _placement_leaves(p_pl))):
                _same(ours, sh.cut(w, dm, pl), f"rank {rank} leaf {i}")
            for i, (ours, w, pl) in enumerate(zip(
                    _pytree.tree_leaves(state.inner),
                    _pytree.tree_leaves(whole_state.inner),
                    _placement_leaves(s_pl.inner))):
                _same(ours, sh.cut(w, dm, pl), f"rank {rank} state {i}")
            assert torch.equal(state.step, whole_state.step)


def test_uneven_shards_are_cut_as_distribute_tensor_cuts(one_thread):
    """Explicit placements on a (3, 2) mesh, the draw's blocks against
    the whole draw cut: pieces of 2, 2, 1 rows; an empty last piece; two
    mesh dimensions on one tensor dimension."""
    from torch.distributed.device_mesh import DeviceMesh

    key = prng.fold_in(prng.key(3, "cpu"), 7)
    cases = [((5, 3), (Shard(0), Shard(1))),
             ((2, 5), (Shard(0), Replicate())),
             ((7, 4), (Shard(0), Shard(0))),
             ((3, 2, 5), (Shard(2), Shard(0)))]
    for rank in range(6):
        with _rank(rank, 6):
            dm = DeviceMesh("cpu", torch.arange(6).reshape(3, 2),
                            mesh_dim_names=("data", "model"))
            coords = dm.get_coordinate()
            for shape, pl in cases:
                block = sh.local_block(shape, pl, (3, 2), coords)
                ours = prng.truncated_normal(key, -2.0, 2.0, shape,
                                             block=block)
                want = sh.cut(prng.truncated_normal(key, -2.0, 2.0, shape),
                              dm, pl).to_local()
                assert ours.shape == want.shape, (shape, pl, coords)
                np.testing.assert_array_equal(_bits(ours), _bits(want))
            assert sh.local_block((2, 5), (Shard(0), Replicate()), (3, 2),
                                  (2, 0)) == ((2, 0), (0, 5))


def test_a_data_axis_that_divides_nothing_leaves_dimensions_whole(
        one_thread):
    """musicgen-medium smoke (d_model 96) on (data 5, model 2): no leaf
    dimension divides over five data ranks, so those stay whole, the
    model axis shards; every rank equals the whole draw cut."""
    cfg = registry.get_config("musicgen-medium", "smoke")
    opt = optim.adamw(optim.cosine_lr(3e-4, 6))
    whole = init_state(cfg, opt, 1, 0, "cpu")[0]
    for rank in (0, 3, 9):
        with _rank(rank, 10):
            mesh = make_mesh((1, 5, 2), AXES, device="cpu",
                             group=dist.group.WORLD)
            params = init_state(cfg, opt, 1, 0, "cpu", mesh=mesh)[0]
            pls = _placement_leaves(sp.train_placements(cfg, opt, mesh,
                                                        (1, 1))[0])
            assert all(not pl[0].is_shard() for pl in pls)
            assert any(pl[1].is_shard() for pl in pls)
            for ours, w, pl in zip(_pytree.tree_leaves(params),
                                   _pytree.tree_leaves(whole), pls):
                _same(ours, sh.cut(w, mesh.shard_mesh, pl), f"rank {rank}")


class _Largest(TorchDispatchMode):
    """The most elements of any tensor an op makes off the meta device."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.numel = max(self.numel, t.numel())
        return out


def test_no_tensor_larger_than_a_shard_or_a_chunk(one_thread, monkeypatch):
    """A rank's init on (data 2, model 2), one superblock, the draw's
    chunk cut to 256 elements: every tensor made (the shards, the
    stacks, the draw's int64 words) within the largest local shard or
    the chunk, which the largest whole leaf is not."""
    monkeypatch.setattr(prng, "_CHUNK", 256)
    cfg = dataclasses.replace(registry.get_config("llama3-8b", "smoke"),
                              n_super=1)
    opt = optim.adamw(optim.cosine_lr(3e-4, 6))
    whole = max(t.numel() for t in _pytree.tree_leaves(
        sp.params_and_axes(cfg)[0]))
    for rank in range(4):
        with _rank(rank, 4):
            mesh = make_mesh((1, 2, 2), AXES, device="cpu",
                             group=dist.group.WORLD)
            largest = _Largest()
            with largest:
                params = init_state(cfg, opt, 1, 0, "cpu", mesh=mesh)[0]
            shard = max(t.to_local().numel()
                        for t in _pytree.tree_leaves(params))
            bound = max(shard, prng._CHUNK)
            assert largest.numel <= bound < whole, (largest.numel, bound,
                                                    whole)


def test_draw_shards_takes_coordinates_alone(one_thread):
    """Without any process group: rank (1, 0)'s shards of (2, 2) are the
    ones `init_state` wraps on that rank."""
    cfg = registry.get_config("zamba2-2.7b", "smoke")
    sizes = {"pod": 1, "data": 2, "model": 2}
    ours = draw_shards(cfg, 1, 0, "cpu", sizes, {"data": 1, "model": 0})
    assert not dist.is_initialized()
    opt = optim.adamw(optim.cosine_lr(3e-4, 6))
    with _rank(2, 4):
        mesh = make_mesh((1, 2, 2), AXES, device="cpu",
                         group=dist.group.WORLD)
        assert list(mesh.shard_mesh.get_coordinate()) == [1, 0]
        params = init_state(cfg, opt, 1, 0, "cpu", mesh=mesh)[0]
        for a, b in zip(_pytree.tree_leaves(ours),
                        _pytree.tree_leaves(params)):
            np.testing.assert_array_equal(_bits(a), _bits(b.to_local()))


def test_bits_at_a_block_are_the_whole_draws(monkeypatch):
    key = prng.fold_in(prng.key(11, "cpu"), 4)
    shape = (6, 7, 5)
    block = ((1, 4), (2, 3), (1, 3))  # no run of it contiguous in shape
    whole = prng.random_bits(key, shape)
    sl = tuple(slice(o, o + n) for o, n in block)
    idx = torch.arange(np.prod(shape)).reshape(shape)[sl]
    assert torch.equal(prng.bits_at(key, idx), whole[sl])
    # the block's draw over several chunks of its elements
    monkeypatch.setattr(prng, "_CHUNK", 7)
    want = prng.truncated_normal(key, -2.0, 2.0, shape, scale=0.5,
                                 out_dtype=torch.bfloat16)
    got = prng.truncated_normal(key, -2.0, 2.0, shape, scale=0.5,
                                out_dtype=torch.bfloat16, block=block)
    np.testing.assert_array_equal(_bits(got), _bits(want[sl]))
    # an empty block, and a 0-d draw's only element
    assert prng.truncated_normal(key, -2.0, 2.0, shape,
                                 block=((0, 0), (0, 7), (0, 5))).shape == (
        0, 7, 5)
    assert torch.equal(prng.truncated_normal(key, -2.0, 2.0, (), block=()),
                       prng.truncated_normal(key, -2.0, 2.0, ()))
