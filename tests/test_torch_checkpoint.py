"""The port's checkpoint manager (`repro_torch.checkpoint`, on
`torch.utils._pytree`) against the reference's (`repro.checkpoint`, on
`jax.tree`): a tree saved by either side restores in the other with equal
arrays and dtypes, a bf16 leaf and the fault layer's snapshot dict among
them. The port flattens in jax's order (dict keys sorted, `None` no leaf),
which is what makes leaf `a<i>` the same leaf in both packages. Also the
manager's own contract, as tests/test_checkpoint.py holds the
reference's: commit marker, keep-k rotation, resume.

Tolerance: none. The files' arrays and dtypes are exact; restored values
are equal (the reference restores a 64-bit leaf as 32-bit, jax's x64
being off, so those are compared at 32 bits).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as ref_restore
from repro.checkpoint import save_tree as ref_save

from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.checkpoint import manager as M


def _fault_snapshot(seed=0, n=5, d=3):
    """A fault layer snapshot as the engines build it
    (`fault_state()`: x, xhat, z, t, comm_iters, in that insertion order)."""
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, d)), "xhat": rng.normal(size=(n, d)),
            "z": rng.normal(size=(n, d)),
            "t": np.arange(n, dtype=np.int64) + seed,
            "comm_iters": np.arange(n, dtype=np.int64) * 2}


def _port_tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 8), generator=gen).to(torch.bfloat16),
            "m": torch.randn((4, 8), generator=gen),
            "step": torch.tensor(7, dtype=torch.int32),
            "skip": None,
            "nested": {"b": torch.ones(3), "a": (torch.zeros(2), None)},
            "snapshot": _fault_snapshot(seed)}


def _as_jax(tree):
    """The same tree as the reference holds it."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                return jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
            return jnp.asarray(v.numpy())
        return np.asarray(v)
    return jax.tree.map(leaf, tree)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 \
        else np.asarray(v)


def _same(ours, theirs):
    """Leaf for leaf equal values; a bf16 leaf bf16 on both sides. (jax
    with x64 off restores 64-bit leaves as 32-bit arrays: the files hold
    the 64-bit values, `test_both_sides_write_the_same_files`.)"""
    a, b = M._flatten(ours)[0], jax.tree.leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.dtype == torch.bfloat16) == (y.dtype == jnp.bfloat16)
        y = _np(y)
        np.testing.assert_array_equal(_np(x).astype(y.dtype), y)


def test_leaf_order_is_jax_order():
    tree = {"b": 1, "a": (2, None), "c": [3]}
    assert M._flatten(tree)[0] == jax.tree.leaves(tree) == [2, 1, 3]
    snap = _fault_snapshot()
    ours = M._flatten(snap)[0]
    for x, y in zip(ours, jax.tree.leaves(snap)):
        assert x is y
    leaves, treedef = M._flatten(tree)
    assert M._unflatten(treedef, [20, 10, 30]) == {"a": (20, None),
                                                    "b": 10, "c": [30]}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _port_tree()
    save_tree(tmp_path / "ck", tree, extra={"sim_time": 1.25})
    restored, extra = ref_restore(tmp_path / "ck", _as_jax(tree))
    assert extra == {"sim_time": 1.25}
    assert restored["w"].dtype == jnp.bfloat16
    assert restored["skip"] is None and restored["nested"]["a"][1] is None
    _same(tree, restored)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _port_tree(seed=3)
    ref_save(tmp_path / "ck", _as_jax(tree), extra={"step": 3})
    restored, extra = restore_tree(tmp_path / "ck", tree)
    assert extra == {"step": 3}
    assert restored["w"].dtype == torch.bfloat16
    assert all(isinstance(v, torch.Tensor)
               for v in M._flatten(restored)[0])
    assert restored["skip"] is None
    _same(restored, _as_jax(tree))


def test_both_sides_write_the_same_files(tmp_path):
    tree = _port_tree(seed=1)
    save_tree(tmp_path / "ours", tree, extra={"k": 1})
    ref_save(tmp_path / "ref", _as_jax(tree), extra={"k": 1})
    assert json.loads((tmp_path / "ours" / "meta.json").read_text()) == \
        json.loads((tmp_path / "ref" / "meta.json").read_text())
    with np.load(tmp_path / "ours" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f])


def test_float8_leaf_roundtrips(tmp_path):
    x = torch.linspace(-2, 2, 8).to(torch.float8_e4m3fn)
    save_tree(tmp_path / "ck", {"q": x})
    got, _ = restore_tree(tmp_path / "ck", {"q": x})
    assert got["q"].dtype == torch.float8_e4m3fn
    assert torch.equal(got["q"].view(torch.uint8), x.view(torch.uint8))
    theirs, _ = ref_restore(tmp_path / "ck", {
        "q": jnp.zeros(8, jnp.float8_e4m3fn)})
    np.testing.assert_array_equal(np.asarray(theirs["q"], np.float32),
                                  x.float().numpy())


def test_commit_marker_required(tmp_path):
    tree = _port_tree()
    save_tree(tmp_path / "ck", tree)
    (tmp_path / "ck" / "COMMIT").unlink()
    with pytest.raises(FileNotFoundError):
        restore_tree(tmp_path / "ck", tree)


def test_manager_keep_k_and_resume(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (10, 20, 30):
        mgr.save(step, _port_tree(step), extra={"step": step},
                 blocking=True)
    assert [s for s, _ in mgr._step_dirs()] == [20, 30]
    step, tree, extra = mgr.restore_latest(_port_tree())
    assert step == 30 and extra["step"] == 30
    _same(tree, _as_jax(_port_tree(30)))
    assert CheckpointManager(tmp_path / "empty").restore_latest(
        _port_tree()) is None


def test_manager_copies_the_tree_when_it_saves(tmp_path):
    """`save` takes host copies at once: a tensor changed after the call
    does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    tree = {"x": torch.ones(4), "y": None}
    mgr.save(1, tree)
    tree["x"].add_(1.0)
    mgr.wait()
    _, got, _ = mgr.restore_latest(tree)
    assert torch.equal(got["x"], torch.ones(4)) and got["y"] is None
