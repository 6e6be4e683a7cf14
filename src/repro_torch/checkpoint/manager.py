"""Checkpointing: atomic msgpack+npz save/restore of arbitrary pytrees with
keep-k rotation and automatic resume -- the restart half of fault tolerance.
The port of `repro.checkpoint.manager`, on `torch.utils._pytree`.

Layout: <dir>/step_<n>/ {tree.msgpack (structure + small leaves),
arrays.npz (numbered large leaves)} plus a COMMIT marker written LAST so a
crash mid-save never yields a checkpoint that restore would trust. Saves
run on a background thread (async checkpointing): the train loop hands off
host copies and keeps stepping.

The files are the reference's, so a checkpoint written by either package
restores in the other. Two rules keep them so:

  * leaf order is jax's: a plain dict's keys sorted, and `None` an empty
    subtree (no leaf). `torch.utils._pytree` alone keeps a dict's insertion
    order and makes `None` a leaf; `_flatten` sorts first and drops the
    `None`s, so leaf `a<i>` is the same leaf on both sides (the fault
    layer's snapshot dict `x, xhat, z, t, comm_iters` among them);
  * bf16 and float8_e4m3fn leaves are stored as a uint view tagged with
    the dtype's name, as the reference stores its ml_dtypes leaves.

Restored leaves are CPU tensors.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as _pytree

PyTree = Any

# COMMIT marker content: restore trusts a checkpoint only when the marker
# holds exactly this token, so a crash that leaves a partial/empty COMMIT
# file behind reads as "not committed" instead of a torn restore source.
_COMMIT_TOKEN = "ok"


def _write_atomic(path: pathlib.Path, writer) -> None:
    """Write a file via temp-name + os.replace so it is all-or-nothing.

    `writer(tmp_path)` produces the full content at the temp path; the
    rename into place is atomic on POSIX, so readers never observe a
    half-written file even if the process dies mid-write."""
    tmp = path.with_name(path.name + ".part")
    writer(tmp)
    os.replace(tmp, path)


def _committed(path: pathlib.Path) -> bool:
    try:
        return (path / "COMMIT").read_text() == _COMMIT_TOKEN
    except OSError:
        return False

# numpy's npz cannot store bf16 and float8 natively: store a uint view plus
# a dtype tag (the reference's tags): tag -> (torch dtype, its uint view)
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8)}


def _canonical(tree: PyTree) -> PyTree:
    """The tree with every plain dict's keys in sorted order, jax's flatten
    order; other containers as they are."""
    if type(tree) is dict:
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_canonical(v) for v in tree]
    if isinstance(tree, tuple):
        items = [_canonical(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):  # OrderedDict, defaultdict, ...: as they are
        return type(tree)({k: _canonical(v) for k, v in tree.items()})
    return tree


def _flatten(tree: PyTree):
    """(leaves, treedef) in jax's order: `None` is no leaf."""
    leaves, spec = _pytree.tree_flatten(_canonical(tree))
    nones = [leaf is None for leaf in leaves]
    return [leaf for leaf in leaves if leaf is not None], (spec, nones)


def _unflatten(treedef, leaves: list) -> PyTree:
    spec, nones = treedef
    it = iter(leaves)
    return _pytree.tree_unflatten([None if none else next(it)
                                   for none in nones], spec)


def _host(leaf):
    """A leaf as the host holds it: a tensor copied to the CPU, anything
    else through `np.asarray`."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array npz can store, dtype tag) for one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        for tag, (dt, view) in _EXOTIC.items():
            if t.dtype == dt:
                return t.view(view).numpy(), tag
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    name = arr.dtype.name if arr.dtype.names is None else str(arr.dtype)
    return arr, name


def _from_numpy(arr: np.ndarray, tag: str) -> torch.Tensor:
    out = torch.from_numpy(arr)
    return out.view(_EXOTIC[tag][0]) if tag in _EXOTIC else out


def save_tree(path: pathlib.Path, tree: PyTree, *, extra: dict | None = None):
    """Atomic synchronous save of a pytree of arrays.

    Safe under concurrent writers: the staging dir is suffixed with the
    writer's pid (two processes saving the same step never share a tmp),
    and losing the commit race to an already-committed sibling is a
    no-op, not an error -- checkpoints are content-deterministic per
    step, so whichever writer wins committed the same bytes."""
    path = pathlib.Path(path)
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, treedef = _flatten(tree)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arr, name = _to_numpy(leaf)
        arrays[f"a{i}"] = arr
        dtypes.append(name)
    def _savez(p):
        with open(p, "wb") as f:  # file handle: savez must not append .npz
            np.savez(f, **arrays)

    _write_atomic(tmp / "arrays.npz", _savez)
    meta = {"n_leaves": len(leaves), "dtypes": dtypes, "extra": extra or {}}
    _write_atomic(tmp / "meta.json",
                  lambda p: p.write_text(json.dumps(meta)))
    _write_atomic(tmp / "COMMIT", lambda p: p.write_text(_COMMIT_TOKEN))
    try:
        if path.exists():
            shutil.rmtree(path, ignore_errors=True)
        tmp.rename(path)
    except OSError:
        if _committed(path):
            # a concurrent writer committed this step first; theirs is
            # whole (COMMIT verified), so dropping our staging copy is
            # the correct outcome of the race
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            raise


def restore_tree(path: pathlib.Path, like: PyTree) -> tuple[PyTree, dict]:
    """Restore into the structure of `like` (shape/dtype checked against
    leaves). Returns (tree, extra)."""
    path = pathlib.Path(path)
    if not _committed(path):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    data = np.load(path / "arrays.npz")
    meta = json.loads((path / "meta.json").read_text())
    leaves, treedef = _flatten(like)
    assert meta["n_leaves"] == len(leaves), "structure mismatch"
    new_leaves = []
    for i, ref in enumerate(leaves):
        arr = data[f"a{i}"]
        ref_shape = getattr(ref, "shape", None)
        assert arr.shape == tuple(ref_shape), (i, arr.shape, ref_shape)
        new_leaves.append(_from_numpy(arr, meta["dtypes"][i]))
    return _unflatten(treedef, new_leaves), meta["extra"]


class CheckpointManager:
    """keep-k rotating checkpoints with async save and latest-resume.

    Multiple managers (including in different processes) may point at the
    same directory: saves stage under per-pid tmp names, rotation
    tolerates concurrent deletion (`FileNotFoundError` means a sibling
    rotated first) and never removes the snapshot this manager just
    wrote, so two writers cannot delete each other's newest work. A
    background-save failure is re-raised from the next `wait()` (or
    `save`/`restore_latest`, which wait first) instead of dying silently
    on the worker thread."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    def _step_dirs(self) -> list[tuple[int, pathlib.Path]]:
        out = []
        for p in self.dir.glob("step_*"):
            if _committed(p):
                try:
                    out.append((int(p.name.split("_")[1]), p))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def save(self, step: int, tree: PyTree, *, extra: dict | None = None,
             blocking: bool = False):
        # device->host copy now
        host_tree = _pytree.tree_map(_host, tree)

        def work():
            try:
                with self._lock:
                    save_tree(self.dir / f"step_{step}", host_tree,
                              extra=extra)
                    self._rotate(protect=step)
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self.wait()
        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def _rotate(self, protect: int | None = None) -> None:
        """Delete committed snapshots beyond the `keep` newest. The
        listing is taken fresh (a sibling process may have rotated since
        the save), a vanished dir is a sibling's rotation (not an
        error), and `protect` pins the step this manager just wrote."""
        dirs = self._step_dirs()
        doomed = dirs[:-self.keep] if self.keep > 0 else dirs
        for step, p in doomed:
            if protect is not None and step >= protect:
                continue
            try:
                shutil.rmtree(p)
            except FileNotFoundError:
                continue

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, like: PyTree) -> tuple[int, PyTree, dict] | None:
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = restore_tree(self.dir / f"step_{step}", like)
        return step, tree, extra
