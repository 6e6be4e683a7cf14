"""Step factories, the port of `repro.launch.steps`: the synchronous train
step, the inference steps (`make_prefill_step`, `make_serve_step`) and the
consensus (multi-pod) wrappers that realize the paper's algorithm at pod
scale.

Every leaf of the state (params, each optimizer leaf, the step counter)
carries a leading pod dimension, as the reference's `pod_stack` lays it
out, and the pods sit on one card. The reference runs its step under
`jax.vmap(spmd_axis_name="pod")` and differentiates the scanned layers
under `jax.checkpoint`; here each pod's forward and backward run with
ordinary autograd on views of the stacked leaves (`torch.utils.checkpoint`
does not compose with `torch.func.vmap`), a layer's parameters as leaves
of their own. The optimizer then updates that pod's views in place
(`Optimizer.update_`), as the reference's jitted step overwrites the
state it donates.

The mix is `core.consensus.tree_mix_gossip` over the pod-stacked leaves:
kernel K1 on the card, in place of the reference's `einsum` with the
mixing matrix over the pod dimension (`_dense_mix`). When the mesh's pod
axis spans the ranks of a process group, each rank holds its pod's shard
of the stacked state (a leading pod dimension of 1, what the reference's
shard_map body sees), and the mix is the reference's collectives
(`core.consensus.mix_collective`) over the group, leaf by leaf and
written back in place: in each leaf's dtype for the mix step (the
reference's `mix_body`), in float32 for the fused step (its `_dense_mix`:
upcast, collective, cast back).

When a pod's replica is sharded (a mesh with a data or model axis above
1, `launch.mesh.Mesh.shard_mesh`), its leaves are DTensors placed by the
sharding rules: the forward gathers each layer's parameters over 'data'
where it runs (FSDP) and redistributes activations at the reference's
`constrain` points (tensor and sequence parallelism over 'model'); the
backward hands each gradient back in its parameter's placements (the
data axis's partial sums reduce-scattered), summed over the microbatches
in float32 in those placements when the step accumulates gradients (each
microbatch's rows brought to the data ranks by an all-to-all of the
tokens). The optimizer's elementwise update then runs on each rank's own
shards, and the mix on them too: K1 over the pods stacked on the rank
(every pod's slice of a leaf lies alike, so the mix of the shards is the
shard of the mix), or the collectives over the DeviceMesh's `pod`
sub-group with one pod a rank.

The inference steps run where their tensors are, without autograd:
prefill returns the last position's logits of `transformer.forward`, and
the serve step is one `transformer.decode_step`, which overwrites the
cache it is given (as the reference's jitted step donates it) and returns
the same tensors. On a serving mesh of ranks (`launch.mesh.
make_serve_mesh`) they run on DTensor parameters, batches, caches and
tokens placed as the reference's dry-run places its inference cells
(`launch.specs.serve_placements`), under its rules, as `grad_fn` runs a
sharded replica: each cache written and attended where it lies.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.utils._pytree as _pytree

from repro_torch.core.consensus import mix_collective, tree_mix_gossip
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.optim import Optimizer, OptState
from repro_torch.launch.specs import serve_rules
from repro_torch.runtime.sharding import (DEFAULT_RULES, is_dtensor,
                                          local_block, logical_to_spec,
                                          use_rules)

PyTree = Any


def _trainable(params: PyTree) -> PyTree:
    """Leaves that require grad, sharing the params' storage: each stacked
    slot leaf as a list of per-layer tensors, the rest whole."""
    def leaf(t):
        return t.detach().requires_grad_()

    out = {}
    for key, value in params.items():
        if key == "stack":
            out[key] = _pytree.tree_map(
                lambda t: [leaf(t[j]) for j in range(t.shape[0])], value)
        else:
            out[key] = _pytree.tree_map(leaf, value)
    return out


def _grads_like(params: PyTree, flat_grads: list[torch.Tensor]) -> PyTree:
    """The flat gradients of `_trainable(params)`'s leaves regrouped like
    params (each slot's per-layer gradients stacked)."""
    it = iter(flat_grads)
    out = {}
    for key, value in params.items():
        if key == "stack":
            out[key] = _pytree.tree_map(
                lambda t: torch.stack([next(it) for _ in range(t.shape[0])]),
                value)
        else:
            out[key] = _pytree.tree_map(lambda t: next(it), value)
    return out


def _replicated(leaves):
    """DTensor's implicit replication of plain tensors (positions, masks)
    beside a sharded replica's DTensors; nothing on one device."""
    if leaves and is_dtensor(leaves[0]):
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _placed_like(g, p):
    """A DTensor gradient redistributed to its parameter's placements
    (the data axis's partial sums reduce-scattered); else `g`."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def grad_fn(params: PyTree, batch: dict, cfg: ModelConfig,
            moe_groups: int = 1) -> tuple[torch.Tensor, PyTree]:
    """(loss, grads) of `transformer.loss_fn` at one pod's params: the
    reference's `jax.value_and_grad`. Gradients are in each leaf's dtype;
    on DTensor params (a sharded replica) they are DTensors with the
    params' placements and the loss is a plain tensor, the same on every
    rank."""
    train = _trainable(params)
    flat = _pytree.tree_leaves(train)
    with torch.enable_grad(), _replicated(flat):
        loss = transformer.loss_fn(train, batch, cfg, moe_groups)
        grads = torch.autograd.grad(loss, flat)
    grads = [_placed_like(g, p) for g, p in zip(grads, flat)]
    loss = loss.detach()
    if is_dtensor(loss):
        loss = loss.full_tensor()
    return loss, _grads_like(params, grads)


def _grad_norm(grads: PyTree) -> torch.Tensor:
    leaves = _pytree.tree_leaves(grads)
    if leaves and is_dtensor(leaves[0]):
        return _sharded_norm(leaves)
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def _sharded_norm(leaves: list) -> torch.Tensor:
    """The 2-norm of DTensor gradients, a plain tensor equal on every
    rank: each rank's sum of squares of its shards, each divided by the
    ranks that hold a copy of it (a power of two on these meshes, so
    exact), summed over the DeviceMesh's ranks one mesh dimension at a
    time."""
    import torch.distributed._functional_collectives as funcol

    mesh = leaves[0].device_mesh
    total = None
    for g in leaves:
        copies = math.prod(mesh.size(d) for d, pl in enumerate(g.placements)
                           if pl.is_replicate())
        part = torch.sum(torch.square(g.to_local().float())) / copies
        total = part if total is None else total + part
    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            total = funcol.wait_tensor(funcol.all_reduce(total, "sum",
                                                         (mesh, d)))
    return torch.sqrt(total)


def _local(tree: PyTree) -> PyTree:
    """Each DTensor leaf's local shard (a view of its storage), plain
    leaves as they are."""
    if tree is None:
        return None
    return _pytree.tree_map(lambda t: t.to_local() if is_dtensor(t) else t,
                            tree)


def _like(local: PyTree, tree: PyTree) -> PyTree:
    """New local shards `local` as DTensors placed as `tree`'s leaves."""
    from torch.distributed.tensor import DTensor

    def one(new, old):
        if not is_dtensor(old):
            return new
        return DTensor.from_local(new, old.device_mesh, old.placements,
                                  run_check=False, shape=old.shape,
                                  stride=old.stride())
    return _pytree.tree_map(one, local, tree)


def _microbatches(batch: dict, microbatches: int) -> list[dict]:
    """The batch's microbatches, the reference's: microbatch m is rows
    [m B/M, (m+1) B/M) of every field. A DTensor batch's microbatches are
    DTensors whose rows lie over 'data' as the rules place a batch of B/M
    rows (sharded where they divide, else whole on every rank), brought
    there by one all-to-all a field over the data ranks (`_regrouped`):
    each rank sends only the rows another needs, never the whole batch
    to every rank."""
    def resh(a):
        return a.reshape((microbatches, a.shape[0] // microbatches)
                         + tuple(a.shape[1:]))
    if not is_dtensor(batch["tokens"]):
        mb = {k: resh(v) for k, v in batch.items()}
        return [{k: v[m] for k, v in mb.items()} for m in range(microbatches)]
    parts = {k: _regrouped(v, microbatches) for k, v in batch.items()}
    return [{k: v[m] for k, v in parts.items()} for m in range(microbatches)]


def _row_ranges(rows: int, pl, size: int, coord: int, at: int = 0
                ) -> tuple[int, int]:
    """[start, end) of the rows of a block of `rows` (from row `at`) that
    the rank at `coord` of a mesh dimension of `size` holds under its
    placement there (`Shard(0)` or whole)."""
    (off, n), = local_block((rows,), (pl,), (size,), (coord,))
    return at + off, at + off + n


def _regrouped(v, microbatches: int) -> list:
    """A DTensor field (rows first) as its M microbatch DTensors, each
    placed as the rules place B/M rows over 'data' (the other mesh
    dimensions as `v`), by one all-to-all of the rows over the data
    ranks (none when `v`'s rows are whole on every rank)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = v.device_mesh
    names = list(dm.mesh_dim_names)
    d = names.index("data")
    D, me = dm.size(d), dm.get_local_rank(d)
    B, rest = v.shape[0], tuple(v.shape[1:])
    if B % microbatches:
        raise ValueError(f"a batch of {B} rows does not split into "
                         f"{microbatches} microbatches")
    rows = B // microbatches
    spec = logical_to_spec((rows,), ("batch",), DEFAULT_RULES,
                           {n: dm.size(i) for i, n in enumerate(names)})
    mb_pl = Shard(0) if spec[0] == "data" else Replicate()
    src_pl = v.placements[d]

    def needed(r):  # the rows rank r holds of every microbatch, in order
        return [_row_ranges(rows, mb_pl, D, r, m * rows)
                for m in range(microbatches)]
    local = v.to_local()
    if src_pl.is_replicate():
        got = torch.cat([local[a:b] for a, b in needed(me)])
    else:
        lo, hi = _row_ranges(B, src_pl, D, me)
        send, sizes_in = [], []
        for r in range(D):  # the rows rank r needs that this rank holds
            mine = [(max(a, lo), min(b, hi)) for a, b in needed(r)]
            mine = [(a, b) for a, b in mine if a < b]
            send += [local[a - lo:b - lo] for a, b in mine]
            sizes_in.append(sum(b - a for a, b in mine))
        sizes_out = []
        for r in range(D):  # what rank r holds of the rows this rank needs
            r_lo, r_hi = _row_ranges(B, src_pl, D, r)
            sizes_out.append(sum(max(0, min(b, r_hi) - max(a, r_lo))
                                 for a, b in needed(me)))
        got = funcol.wait_tensor(funcol.all_to_all_single(
            torch.cat(send), sizes_out, sizes_in, (dm, d)))
    placements = list(v.placements)
    placements[d] = mb_pl
    shape = torch.Size((rows,) + rest)
    stride = torch.empty(shape, device="meta").stride()
    per = got.shape[0] // microbatches
    return [DTensor.from_local(got[m * per:(m + 1) * per], dm, placements,
                               run_check=False, shape=shape, stride=stride)
            for m in range(microbatches)]


def _loss_and_grads(params, batch, cfg: ModelConfig, moe_groups: int,
                    microbatches: int):
    if microbatches == 1:
        return grad_fn(params, batch, cfg, moe_groups)
    # gradient accumulation over the reference's microbatches: fp32 sums
    # of their gradients and losses, each gradient's accumulator in the
    # gradient's placements (a rank holds its shard's)
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    g_acc = _pytree.tree_map(
        lambda p_: torch.zeros_like(p_, dtype=torch.float32), params)
    for mb in _microbatches(batch, microbatches):
        loss, g = grad_fn(params, mb, cfg, moe_groups)
        g_acc = _pytree.tree_map(lambda a, b: a + b.float(), g_acc, g)
        loss_acc = loss_acc + loss
    return (loss_acc / microbatches,
            _pytree.tree_map(lambda g: g / microbatches, g_acc))


def apply_update(optimizer: Optimizer, grads: PyTree, opt_state,
                 params: PyTree) -> torch.Tensor:
    """The train step's tail: the optimizer's update of `params` and
    `opt_state` in place (`Optimizer.update_`, elementwise: a sharded
    replica's on each rank's own shards, as the consensus steps update
    them), then the gradients' 2-norm, returned."""
    optimizer.update_(_local(grads), _local(opt_state), _local(params))
    return _grad_norm(grads)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    moe_groups: int = 1, microbatches: int = 1):
    """Synchronous step on one replica: (params, opt_state, batch) ->
    (params, opt_state, metrics). It overwrites the params and opt_state
    it is given (`apply_update`) and returns them, as the reference's
    jitted step with `donate_argnums=(0, 1)` reuses their buffers: no
    second copy of the state is made. `microbatches` > 1 runs gradient
    accumulation (`_microbatches`, fp32 gradient sums). `moe_groups` is
    the MoE dispatch groups (`mlp.moe_apply`'s `groups`); the dense
    blocks ignore it."""

    def train_step(params, opt_state, batch):
        loss, grads = _loss_and_grads(params, batch, cfg, moe_groups,
                                      microbatches)
        grad_norm = apply_update(optimizer, grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    return train_step


@contextlib.contextmanager
def _serving(params: PyTree, mesh):
    """Where the inference steps run: without autograd, with DTensor's
    implicit replication of plain tensors (positions, masks) beside DTensor
    parameters, and, given a serving mesh, under its rules
    (`specs.serve_rules`: the reference's constraints)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.no_grad())
        stack.enter_context(_replicated(_pytree.tree_leaves(params)))
        if mesh is not None:
            stack.enter_context(use_rules(serve_rules(mesh), mesh))
        yield


def make_prefill_step(cfg: ModelConfig, moe_groups: int = 1, mesh=None):
    """Forward-only (inference prefill): (params, batch) -> the logits of
    the last position (B, V). `batch["enc"]`, when present, is the VLM's
    encoder states. On a serving mesh (`launch.mesh.make_serve_mesh`) the
    params and batch are DTensors placed by `specs.serve_placements`, the
    step runs under the mesh's rules and the logits come back as a DTensor
    in the reference's ("batch", "vocab") placement."""

    def prefill_step(params, batch):
        with _serving(params, mesh):
            logits = transformer.forward(params, batch["tokens"], cfg,
                                         enc=batch.get("enc"),
                                         moe_groups=moe_groups)
            # a copy: the view would hold the whole (B, S, V) logits
            return logits[:, -1, :].clone()

    return prefill_step


def make_serve_step(cfg: ModelConfig, moe_groups: int = 1, mesh=None):
    """One-token decode: (params, cache, tokens, pos) -> (logits, cache),
    the cache written in place; `pos` an int or a 0-d integer tensor. On a
    serving mesh the params, cache and tokens are DTensors placed by
    `specs.serve_placements` (a DTensor `pos` is replicated), every cache
    is written where it lies and never gathered, and the logits come back
    as a DTensor in the reference's ("batch", "seq", "vocab") placement."""

    def serve_step(params, cache, tokens, pos):
        if is_dtensor(pos):
            pos = pos.to_local()
        with _serving(params, mesh):
            return transformer.decode_step(params, cache, tokens, pos, cfg,
                                           moe_groups=moe_groups)

    return serve_step


def _pod(tree: PyTree, i: int) -> PyTree:
    """Pod i's views of a pod-stacked tree. None (the state of SGD without
    momentum) stays None: some torch versions map a function over None as
    over a leaf, others take it for an empty tree, as jax does."""
    if tree is None:
        return None
    return _pytree.tree_map(lambda a: a[i], tree)


def _rank_mix(tree: PyTree, graph, mesh, float32: bool) -> PyTree:
    """This rank's pod of every leaf of `tree` (leading pod dimension 1)
    mixed over the mesh's process group, one leaf at a time (in float32
    when asked, so no float32 copy of the whole tree is held), the result
    written back into the leaf."""
    with mesh.bind():
        for leaf in _pytree.tree_leaves(tree):
            pod = leaf[0]
            mixed = mix_collective(pod.float() if float32 else pod, graph,
                                   "pod")
            pod.copy_(mixed)
            del mixed
    return tree


def make_consensus_steps(cfg: ModelConfig, optimizer: Optimizer, graph,
                         mesh, moe_groups: int = 1,
                         mix_target: str = "params",
                         microbatches: int = 1):
    """Returns (local_step, mix_step, fused_step) for consensus training
    on pod-stacked state (graph.n pods on `mesh.device`, or this rank's pod
    when the mesh's pod axis spans a process group). Each takes and
    returns (params, opt_state[, batch]) and overwrites the state it is
    given (the mix returns the mixed tensors in their place), as the
    reference's jitted steps consume the state they donate.
    `mix_target` selects what the consensus averages:
      "params" -- gossip parameter averaging (consensus-SGD; section VI)
      "z"      -- faithful DDA: mix the dual (accumulated-gradient) state
                  held by the dual_averaging optimizer.
    `microbatches` > 1 accumulates each pod's gradients over the
    reference's microbatches, on a sharded replica too (its microbatches
    regrouped over the data ranks by an all-to-all, `_microbatches`).

    local_step: one optimizer step per pod on its own data shard, no
      mixing (the paper's cheap iteration, cost 1/n); metrics "loss" and
      "grad_norm" are (n_pods,) float32 tensors.
    mix_step: consensus mixing only (the communication half of an
      expensive iteration, cost kr): K1 on every pod-stacked leaf, or the
      collectives in each leaf's dtype across ranks.
    fused_step: local then mix (an expensive iteration, 1/n + kr); across
      ranks the collectives in float32.
    """
    if mix_target not in ("params", "z"):
        raise ValueError(f"mix_target must be 'params' or 'z', got "
                         f"{mix_target!r}")

    def local(params, opt_state, batch):
        n = batch["tokens"].shape[0]
        losses, norms = [], []
        for i in range(n):
            p_i = _pod(params, i)
            st_i = OptState(opt_state.step[i], _pod(opt_state.inner, i))
            loss, grads = _loss_and_grads(p_i, _pod(batch, i), cfg,
                                          moe_groups, microbatches)
            norms.append(_grad_norm(grads))
            # sharded: the elementwise update on each rank's own shards
            grads = _pytree.tree_map(lambda g: g.contiguous(),
                                     _local(grads))
            optimizer.update_(grads, OptState(st_i.step, _local(st_i.inner)),
                              _local(p_i))
            losses.append(loss)
            del grads
        return params, opt_state, {"loss": torch.stack(losses),
                                   "grad_norm": torch.stack(norms)}

    ranked = mesh.pod_group is not None

    def mixed(params, opt_state, float32: bool):
        def one(tree):
            if ranked:  # in place on each rank's shards
                _rank_mix(_local(tree), graph, mesh, float32)
                return tree
            # the mix of the local shards is the shard of the mix: every
            # pod's slice of a leaf lies alike
            return _like(tree_mix_gossip(_local(tree), graph,
                                         device=mesh.device), tree)
        if mix_target == "params":
            return one(params), opt_state
        inner = dict(opt_state.inner)
        inner["z"] = one(inner["z"])
        return params, OptState(opt_state.step, inner)

    def mix(params, opt_state):
        return mixed(params, opt_state, float32=False)

    def fused(params, opt_state, batch):
        params, opt_state, metrics = local(params, opt_state, batch)
        params, opt_state = mixed(params, opt_state, float32=True)
        return params, opt_state, metrics

    return local, mix, fused
