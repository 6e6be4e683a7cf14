"""Step factories, the port of `repro.launch.steps`' training half: the
synchronous train step and the consensus (multi-pod) wrappers that realize
the paper's algorithm at pod scale.

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
mixing matrix over the pod dimension (`_dense_mix`) or its ppermutes
across chips. Prefill and decode steps come with a later slice.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as _pytree

from repro_torch.core.consensus import tree_mix_gossip
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.optim import Optimizer, OptState

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


def grad_fn(params: PyTree, batch: dict, cfg: ModelConfig,
            moe_groups: int = 1) -> tuple[torch.Tensor, PyTree]:
    """(loss, grads) of `transformer.loss_fn` at one pod's params: the
    reference's `jax.value_and_grad`. Gradients are in each leaf's dtype."""
    train = _trainable(params)
    flat = _pytree.tree_leaves(train)
    with torch.enable_grad():
        loss = transformer.loss_fn(train, batch, cfg, moe_groups)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), _grads_like(params, list(grads))


def _grad_norm(grads: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in _pytree.tree_leaves(grads)))


def _loss_and_grads(params, batch, cfg: ModelConfig, moe_groups: int,
                    microbatches: int):
    if microbatches == 1:
        return grad_fn(params, batch, cfg, moe_groups)
    # gradient accumulation: the batch split along its leading dim, fp32
    # sums of the microbatches' gradients and losses
    def resh(a):
        return a.reshape((microbatches, a.shape[0] // microbatches)
                         + tuple(a.shape[1:]))
    mb = {k: resh(v) for k, v in batch.items()}
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    g_acc = _pytree.tree_map(
        lambda p_: torch.zeros(p_.shape, dtype=torch.float32,
                               device=p_.device), params)
    for m in range(microbatches):
        loss, g = grad_fn(params, {k: v[m] for k, v in mb.items()}, cfg,
                          moe_groups)
        g_acc = _pytree.tree_map(lambda a, b: a + b.float(), g_acc, g)
        loss_acc = loss_acc + loss
    return (loss_acc / microbatches,
            _pytree.tree_map(lambda g: g / microbatches, g_acc))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    moe_groups: int = 1, microbatches: int = 1):
    """Pure synchronous step on one replica: (params, opt_state, batch) ->
    (params, opt_state, metrics), new tensors. `microbatches` > 1 runs
    gradient accumulation (the batch split along its leading dim, fp32
    gradient sums). `moe_groups` is the MoE dispatch groups
    (`mlp.moe_apply`'s `groups`); the dense blocks ignore it."""
    transformer.check_config(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = _loss_and_grads(params, batch, cfg, moe_groups,
                                      microbatches)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss,
                                       "grad_norm": _grad_norm(grads)}

    return train_step


def _pod(tree: PyTree, i: int) -> PyTree:
    """Pod i's views of a pod-stacked tree. None (the state of SGD without
    momentum) stays None: some torch versions map a function over None as
    over a leaf, others take it for an empty tree, as jax does."""
    if tree is None:
        return None
    return _pytree.tree_map(lambda a: a[i], tree)


def make_consensus_steps(cfg: ModelConfig, optimizer: Optimizer, graph,
                         mesh, moe_groups: int = 1,
                         mix_target: str = "params",
                         microbatches: int = 1):
    """Returns (local_step, mix_step, fused_step) for consensus training
    on pod-stacked state (graph.n pods on `mesh.device`). Each takes and
    returns (params, opt_state[, batch]) and overwrites the state it is
    given (the mix returns the mixed tensors in their place), as the
    reference's jitted steps consume the state they donate.
    `mix_target` selects what the consensus averages:
      "params" -- gossip parameter averaging (consensus-SGD; section VI)
      "z"      -- faithful DDA: mix the dual (accumulated-gradient) state
                  held by the dual_averaging optimizer.

    local_step: one optimizer step per pod on its own data shard, no
      mixing (the paper's cheap iteration, cost 1/n); metrics "loss" and
      "grad_norm" are (n_pods,) float32 tensors.
    mix_step: consensus mixing only (the communication half of an
      expensive iteration, cost kr): K1 on every pod-stacked leaf.
    fused_step: local then mix (an expensive iteration, 1/n + kr).
    """
    if mix_target not in ("params", "z"):
        raise ValueError(f"mix_target must be 'params' or 'z', got "
                         f"{mix_target!r}")
    transformer.check_config(cfg)

    def local(params, opt_state, batch):
        n = batch["tokens"].shape[0]
        losses, norms = [], []
        for i in range(n):
            p_i = _pod(params, i)
            st_i = OptState(opt_state.step[i], _pod(opt_state.inner, i))
            loss, grads = _loss_and_grads(p_i, _pod(batch, i), cfg,
                                          moe_groups, microbatches)
            optimizer.update_(grads, st_i, p_i)
            losses.append(loss)
            norms.append(_grad_norm(grads))
            del grads
        return params, opt_state, {"loss": torch.stack(losses),
                                   "grad_norm": torch.stack(norms)}

    def mix(params, opt_state):
        if mix_target == "params":
            return tree_mix_gossip(params, graph, device=mesh.device), \
                opt_state
        inner = dict(opt_state.inner)
        inner["z"] = tree_mix_gossip(inner["z"], graph, device=mesh.device)
        return params, OptState(opt_state.step, inner)

    def fused(params, opt_state, batch):
        params, opt_state, metrics = local(params, opt_state, batch)
        params, opt_state = mix(params, opt_state)
        return params, opt_state, metrics

    return local, mix, fused
