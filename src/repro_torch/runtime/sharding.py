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

The port places tensors by these specs as DTensor placements
(`to_placements`: one `Shard(dim)` per mesh dimension a spec entry names,
`Replicate()` on the others; `tree_placements`, the counterpart of the
reference's `tree_shardings`) on the `torch.distributed` DeviceMesh of
the axes that span ranks (`launch.mesh.Mesh.shard_mesh`). A spec entry
naming an axis the DeviceMesh lacks (the pod axis when the pods stack on
every rank) leaves that dimension whole. `constrain` redistributes a
DTensor activation to its spec under the installed rules (the reference's
`with_sharding_constraint`) and returns anything else unchanged, so a
one-device run never sees it.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Any, Sequence

import torch
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
    _ASSIGN_PRIORITY order (then position order). A rule's candidate may
    be a composite tuple of axes (the serving rules' ("pod", "data")
    batch), sharded when its axes' product divides the dimension."""
    axes = list(axes)
    shape = list(shape)
    used: set = set()
    out: list[Any] = [None] * len(axes)
    order = sorted(range(len(out)),
                   key=lambda i: (_ASSIGN_PRIORITY.get(axes[i], 1), i))
    for i in order:
        name = axes[i]
        for cand in (rules.get(name, ()) if name else ()):
            if cand in used:
                continue
            size = _axis_size(cand, mesh_shape)
            if size > 1 and shape[i] % size == 0:
                out[i] = cand
                used.add(cand)
                break
    return tuple(out)


def _axis_size(cand, mesh_shape: dict[str, int]) -> int:
    """Ranks a rule's candidate spans: a mesh axis's size, or the product
    of a composite's (("pod", "data"), the serving batch's)."""
    if isinstance(cand, tuple):
        return math.prod(mesh_shape.get(c, 1) for c in cand)
    return mesh_shape.get(cand, 1)


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


def is_dtensor(x) -> bool:
    """True for a `torch.distributed.tensor.DTensor` (imported only when
    torch.distributed is, so a one-device run never loads it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def to_placements(spec: Spec, device_mesh) -> tuple:
    """DTensor placements of a spec on `device_mesh` (a DeviceMesh, or its
    dimension names): `Shard(dim)` on each mesh dimension that spec entry
    `dim` names, `Replicate()` on the others. A composite entry such as
    ("pod", "data") shards its dimension over both mesh dimensions, which
    must come in the mesh's order; an axis the mesh lacks is left out."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(getattr(device_mesh, "mesh_dim_names", device_mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        last = -1
        for a in axes:
            if a not in names:
                continue
            m = names.index(a)
            if m < last:
                raise ValueError(f"spec entry {entry} shards dimension {dim} "
                                 f"against the mesh's order {names}")
            out[m], last = Shard(dim), m
    return tuple(out)


def constrain(x, axes: Sequence[str | None]):
    """The reference's activation sharding constraint: under installed
    rules a DTensor is redistributed to `spec_for(x, axes)`'s placements
    on its own DeviceMesh (a no-op when it lies so already); a plain
    tensor, or any tensor without rules, comes back unchanged."""
    if not rules_active() or not is_dtensor(x):
        return x
    placements = to_placements(spec_for(x, axes), x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_axis(tree: PyTree, axis: str | tuple[str, ...] = "data"
                ) -> PyTree:
    """Every DTensor leaf of `tree` gathered over the mesh dimension `axis`
    (or each of a tuple of them, in one redistribute: their placements
    made `Replicate()`, the others kept), anything else as it is: the FSDP
    gather of a layer's parameters before use. Its backward
    reduce-scatters the gradients back to the parameters' placements.
    Without installed rules the tree comes back as it is."""
    if not rules_active():
        return tree
    from torch.distributed.tensor import Replicate

    axes = (axis,) if isinstance(axis, str) else axis

    def one(t):
        if not is_dtensor(t):
            return t
        names = t.device_mesh.mesh_dim_names or ()
        placements = [Replicate() if n in axes else pl
                      for n, pl in zip(names, t.placements)]
        if placements == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, placements)
    return _pytree.tree_map(one, tree)


def _einsum(eq: str, x, w):
    """`torch.einsum(eq, x, w)` in the operands' promoted dtype, as jax
    promotes them (an operand already in it is taken as it is)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(eq, x.to(dt), w.to(dt))


def project(eq: str, x, *weights, keep_weights: bool = False):
    """The product `einsum(eq, x, w)` of an activation `x` with a weight
    `w` (dtypes promoted, `_einsum`), or a tuple of them, one for each of
    several weights that take the same x. On plain tensors it is that
    einsum. On DTensors it runs on each rank's local shards (`local_map`),
    so DTensor never views a sharded product, and each mesh dim decides
    one of these layouts:

      * x's token dims (labels of x and the output alone) sharded there:
        the weight whole there, its gradient a partial sum over the ranks'
        tokens; with `keep_weights` (a decode step's few tokens) x is
        gathered there instead wherever the weight is sharded;
      * x sharded on a dim it shares with the weight: the weight sliced to
        match (or as it lies), the output sharded on that dim, or a
        partial sum where it is contracted;
      * x whole there: the weight as it lies; an output dim of the weight
        sharded gives the output so sharded (x's gradient a partial sum),
        a contracted dim sharded slices x to match (a partial sum out).

    x's partial sums are reduced first, and x is redistributed once for
    the weights that need the same layout of it. Each weight goes from
    its stored placements to these in one redistribute, whose backward
    takes its gradient back in one too (the token ranks' partial sums
    reduce-scattered over every mesh dim at once)."""
    if not (is_dtensor(x) and all(is_dtensor(w) for w in weights)):
        out = tuple(_einsum(eq, x, w) for w in weights)
        return out[0] if len(out) == 1 else out
    from torch.distributed.tensor.experimental import local_map

    ins, lo = eq.replace(" ", "").split("->")
    lx, lw = ins.split(",")
    mesh = x.device_mesh
    laid = {}                      # x in each layout the weights ask for
    out = []
    for w in weights:
        x_to, w_to, o_pl, x_grad, w_grad = _layouts(
            lx, lw, lo, x.placements, w.placements, keep_weights)
        if x_to not in laid:
            laid[x_to] = (x if x_to == tuple(x.placements)
                          else x.redistribute(mesh, x_to))
        if w_to != tuple(w.placements):
            w = w.redistribute(mesh, w_to)
        out.append(local_map(lambda a, b: _einsum(eq, a, b),
                             out_placements=(o_pl,),
                             in_placements=(x_to, w_to),
                             in_grad_placements=(x_grad, w_grad),
                             device_mesh=mesh)(laid[x_to], w))
    return out[0] if len(out) == 1 else tuple(out)


def _layouts(lx: str, lw: str, lo: str, x_pl, w_pl, keep_weights: bool):
    """`project`'s placements of one product, mesh dim by mesh dim, from
    the labels of x, the weight and the output: (x's, the weight's, the
    output's, x's gradient's, the weight's gradient's)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    x_to = [Replicate() if pl.is_partial() else pl for pl in x_pl]
    w_to = list(w_pl)
    out, x_grad, w_grad = [], [], []
    for m in range(len(x_to)):
        a = lx[x_to[m].dim] if x_to[m].is_shard() else None
        b = lw[w_to[m].dim] if w_to[m].is_shard() else None
        if a is not None and a not in lw and a in lo:        # a token dim
            if not (keep_weights and b is not None):
                w_to[m] = Replicate()
                out.append(Shard(lo.index(a)))
                x_grad.append(x_to[m])
                w_grad.append(Partial())
                continue
            a = None
        elif a is not None and (a not in lw or b not in (None, a)):
            a = None      # summed in x alone, or the weight sharded apart
        if a is not None:                                    # shared dim
            w_to[m] = Shard(lw.index(a))
            out.append(Shard(lo.index(a)) if a in lo else Partial())
            x_grad.append(x_to[m])
            w_grad.append(w_to[m])
            continue
        x_to[m] = Replicate()
        if b is None:
            out.append(Replicate())
            x_grad.append(Replicate())
        elif b not in lx:                                    # w's output
            out.append(Shard(lo.index(b)) if b in lo else Partial())
            x_grad.append(Partial())
        else:                                  # x sliced to w's shard
            x_to[m] = Shard(lx.index(b))
            out.append(Shard(lo.index(b)) if b in lo else Partial())
            x_grad.append(x_to[m])
        w_grad.append(w_to[m])
    return (tuple(x_to), tuple(w_to), tuple(out), tuple(x_grad),
            tuple(w_grad))


def cut(t, device_mesh, placements):
    """This rank's shard of a whole tensor `t` (the same on every rank) as
    a DTensor on `device_mesh`, without communication; a shard that is a
    view of `t` is copied, so that `t` can be freed (a replicated one is
    `t` itself)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    local = distribute_tensor(t, device_mesh, placements,
                              src_data_rank=None).to_local()
    if local.numel() < t.numel():
        local = local.clone()
    return DTensor.from_local(local, device_mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def local_block(shape: Sequence[int], placements, dim_sizes: Sequence[int],
                coords: Sequence[int]) -> tuple[tuple[int, int], ...]:
    """The (offset, length) a dimension of the shard of a tensor of `shape`
    that the rank at `coords` on a mesh of `dim_sizes` holds under
    `placements`, as `distribute_tensor` cuts it (and `cut`): the mesh
    dimensions in order, each `Shard(d)` splitting dimension d's extent
    so far into `torch.chunk`'s pieces (ceil-sized, the last short or
    empty). Needs the coordinates alone, no process group."""
    off, length = [0] * len(shape), list(shape)
    for pl, size, c in zip(placements, dim_sizes, coords):
        if pl.is_shard():
            d = pl.dim
            piece = -(-length[d] // size)
            start = min(c * piece, length[d])
            off[d] += start
            length[d] = min(start + piece, length[d]) - start
    return tuple(zip(off, length))


def block_rule(rules: dict[str, tuple[str, ...]], mesh_sizes: dict[str, int],
               dims: Sequence[str], coords: dict[str, int]):
    """The rule `models.common.drawing_blocks` takes: a leaf of (shape,
    logical axes) to the block of it that the rank at `coords` (its index
    on each mesh dimension of `dims`) holds, placed as `logical_to_spec`
    and `to_placements` place it on the mesh of `mesh_sizes`."""
    sizes = [mesh_sizes[d] for d in dims]
    at = [coords[d] for d in dims]

    def block_of(shape, axes):
        spec = logical_to_spec(shape, axes, rules, mesh_sizes)
        return local_block(shape, to_placements(spec, tuple(dims)), sizes,
                           at)
    return block_of


def is_placements_leaf(x) -> bool:
    """A tuple of DTensor placements (one a mesh dimension)."""
    return isinstance(x, tuple) and all(hasattr(pl, "is_shard") for pl in x)


def place(tree: PyTree, placements: PyTree, device_mesh) -> PyTree:
    """Every leaf of a plain `tree` (whole, the same on every rank) cut to
    this rank's shard by the parallel tree of placements (`cut`)."""
    flat, treedef = _pytree.tree_flatten(tree)
    pls = _pytree.tree_leaves(placements, is_leaf=is_placements_leaf)
    if len(flat) != len(pls):
        raise ValueError(f"{len(flat)} leaves against {len(pls)} "
                         f"placements")
    return _pytree.tree_unflatten(
        [cut(t, device_mesh, pl) for t, pl in zip(flat, pls)], treedef)


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


def tree_placements(abstract_tree: PyTree, axes_tree: PyTree, mesh,
                    device_mesh,
                    rules: dict[str, tuple[str, ...]] | None = None
                    ) -> PyTree:
    """DTensor placements on `device_mesh` for a whole tree, from
    `tree_specs` on `mesh` (the reference's `tree_shardings`)."""
    specs = tree_specs(abstract_tree, axes_tree, mesh, rules)
    return _pytree.tree_map(
        lambda s: to_placements(s, device_mesh), specs,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            e is None or isinstance(e, (str, tuple)) for e in x))
