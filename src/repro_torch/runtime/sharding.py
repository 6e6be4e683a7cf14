"""Logical-axis sharding rules (MaxText-style), the port of
`repro.runtime.sharding`.

Model code annotates params and activations with LOGICAL axis names
("batch", "embed", "q_heads", ...). A rules table maps logical names to
mesh axes, and `logical_to_spec` resolves a leaf's logical axes to a spec:
a tuple with one entry per dimension, each a mesh axis name, None
(replicated), or a tuple of names (a composite axis such as
("pod", "data")). It is the reference's `PartitionSpec` as a plain tuple,
so `tuple(reference_spec) == port_spec` leaf for leaf.

A logical axis is only sharded if the dimension is divisible by the mesh
axis size (e.g. llama3's 8 KV heads stay replicated on a model=16 mesh and
the KV cache is sharded over sequence instead -- see DEFAULT_RULES).

The port reckons with these specs (the dry-run's per-device bytes,
`launch/specs.py`); it does not yet place tensors by them. Only the `pod`
axis spans processes, as one pod per rank, so `constrain` returns its
input unchanged, and the reference's `tree_shardings` (`NamedSharding`s
for `in_shardings`) has no counterpart until the data and model axes
execute as DTensor placements.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Sequence

import torch.utils._pytree as _pytree

PyTree = Any
#: a spec entry: a mesh axis, None, or a composite tuple of axes
Spec = tuple

# logical axis -> preference-ordered candidate mesh axes
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("data",),
    "seq": (),
    # residual stream BETWEEN blocks: sequence-parallel over 'model'
    # (Megatron SP)
    "seq_sp": ("model",),
    "cache_seq": ("model",),       # decode KV/state cache: sequence-sharded
    "embed": ("data",),            # FSDP: shard params' d_model over data
    "embed_act": (),               # activations' d_model: replicated
    "q_heads": ("model",),
    "kv_heads": ("model",),
    # head dim is only ever sharded as the decode-cache fallback (weights'
    # head dims lose to q/kv_heads via _ASSIGN_PRIORITY + the used-set)
    "head": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "kv_lora": (),
    "q_lora": (),   # never steal 'model' from q_heads in the MLA up-projs
    "conv": (),
    "state": (),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "layers": (),
    "lora": (),
    "enc_tokens": ("model",),
    "enc_embed": (),
}


class _Ctx(threading.local):
    def __init__(self):
        self.rules: dict[str, tuple[str, ...]] | None = None
        self.mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(rules: dict[str, tuple[str, ...]], mesh):
    """Install `rules` on `mesh` for this thread; the previous pair comes
    back on exit, so contexts nest."""
    prev = (_CTX.rules, _CTX.mesh)
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev


# Lower value = assigned first when several logical axes compete for the
# same mesh axis. cache_seq is the LAST resort: a write into a sharded
# sequence dim reshards the whole cache every decode step, so decode
# caches prefer head-sharding (kv_heads, then head) over seq.
_ASSIGN_PRIORITY = {
    "batch": 0, "seq_sp": 0, "embed": 0, "experts": 0, "enc_tokens": 0,
    "kv_heads": 1, "q_heads": 1, "mlp": 1, "vocab": 1, "ssm_inner": 1,
    "ssm_heads": 1,
    "head": 2,
    "cache_seq": 3,
}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh (`launch.mesh.Mesh`)."""
    return dict(zip(mesh.axis_names, mesh.shape))


def logical_to_spec(shape: Sequence[int], axes: Sequence[str | None],
                    rules: dict[str, tuple[str, ...]],
                    mesh_shape: dict[str, int]) -> Spec:
    """Resolve logical axes to a spec, honoring divisibility and never
    assigning one mesh axis twice. Competing axes are resolved in
    _ASSIGN_PRIORITY order (then position order)."""
    axes = list(axes)
    shape = list(shape)
    used: set[str] = set()
    out: list[Any] = [None] * len(axes)
    order = sorted(range(len(out)),
                   key=lambda i: (_ASSIGN_PRIORITY.get(axes[i], 1), i))
    for i in order:
        name = axes[i]
        for cand in (rules.get(name, ()) if name else ()):
            if cand in used:
                continue
            size = mesh_shape.get(cand, 1)
            if size > 1 and shape[i] % size == 0:
                out[i] = cand
                used.add(cand)
                break
    return tuple(out)


def spec_for(x, axes: Sequence[str | None],
             rules: dict[str, tuple[str, ...]] | None = None,
             mesh=None) -> Spec:
    """`logical_to_spec` of `x`'s shape under the given rules and mesh, or
    the installed ones (`use_rules`)."""
    rules = rules if rules is not None else _CTX.rules
    mesh = mesh if mesh is not None else _CTX.mesh
    return logical_to_spec(x.shape, axes, rules, mesh_axis_sizes(mesh))


def rules_active() -> bool:
    """True when the launcher installed sharding rules (production mesh);
    model code uses this to pick distribution-aware compute paths."""
    return _CTX.rules is not None and _CTX.mesh is not None


def constrain(x, axes: Sequence[str | None]):
    """The reference's activation sharding constraint. Returns `x`
    unchanged: no axis but `pod` spans processes yet, and a pod's tensors
    lie whole on its rank. Once the data and model axes execute it
    becomes a DTensor redistribute to `spec_for(x, axes)` when rules are
    active."""
    return x


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_specs(abstract_tree: PyTree, axes_tree: PyTree, mesh,
               rules: dict[str, tuple[str, ...]] | None = None) -> PyTree:
    """Specs for a whole tree: flatten the value tree and the parallel
    logical-axes tree (whose leaves are tuples) independently."""
    rules = rules if rules is not None else DEFAULT_RULES
    mesh_shape = mesh_axis_sizes(mesh)
    flat_v, treedef = _pytree.tree_flatten(abstract_tree)
    flat_a = _pytree.tree_flatten(axes_tree, is_leaf=is_axes_leaf)[0]
    if len(flat_v) != len(flat_a):
        raise ValueError(f"{len(flat_v)} leaves against {len(flat_a)} "
                         f"logical-axes tuples")
    specs = [logical_to_spec(v.shape, a, rules, mesh_shape)
             for v, a in zip(flat_v, flat_a)]
    return _pytree.tree_unflatten(specs, treedef)
