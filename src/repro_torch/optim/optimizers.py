"""Optimizers as (init, update) pairs, the port of `repro.optim.optimizers`.

`dual_averaging` is the paper's inner update (eq. 3-4 without the consensus
term, which the launcher applies through `core.consensus`): the state
carries the accumulated subgradient z and the primal is x = -a(t) z.
`adamw`/`sgd` are the substrate optimizers for the consensus-SGD (section
VI) LM training mode.

Adam moments are fp32 regardless of param dtype (or `moment_dtype`);
updates are computed in fp32 and cast back (bf16 params + fp32 state, no
separate fp32 master copy), as the reference computes them. Each
optimizer's arithmetic is one elementwise rule per leaf, driven one way,
`update_(grads, state, params)`: in place, chunk by chunk of each leaf's
elements. That is the launcher's step, which, like the reference's jitted
step that donates its inputs, overwrites the parameters and the state; a
full-width leaf of hundreds of millions of elements never holds its
float32 temporaries at once. `update(grads, state, params) -> (params,
state)`, the reference's pure function, runs `update_` on copies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.utils._pytree as _pytree

PyTree = Any

#: elements of a leaf an in-place update computes at once
_CHUNK = 1 << 26


class OptState(NamedTuple):
    step: torch.Tensor
    inner: PyTree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    #: the in-place update: (grads, state, params) -> None
    update_: Callable[[PyTree, OptState, PyTree], None]
    name: str = "opt"

    def update(self, grads: PyTree, state: OptState, params: PyTree
               ) -> tuple[PyTree, OptState]:
        """The reference's pure update: `update_` on copies of params and
        state, which come back as new tensors."""
        def copy(t):
            if t is None:  # sgd without momentum keeps no state
                return None
            return t.clone(memory_format=torch.contiguous_format)
        params = _pytree.tree_map(copy, params)
        state = _pytree.tree_map(copy, state)
        self.update_(grads, state, params)
        return params, state


def _zeros_like(tree: PyTree, dtype) -> PyTree:
    return _pytree.tree_map(
        lambda x: torch.zeros(x.shape, dtype=dtype, device=x.device), tree)


def _step0(params: PyTree) -> torch.Tensor:
    leaves = _pytree.tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _in_place(rule, scalars, grads: PyTree, state_trees: list[PyTree],
              params: PyTree) -> None:
    """Apply `rule(scalars, p, g, *s) -> (new_p, *new_s)` to every leaf,
    writing the results into p and the state leaves, `_CHUNK` elements at a
    time (each leaf contiguous)."""
    flat_p = _pytree.tree_leaves(params)
    flat_g = _pytree.tree_leaves(grads)
    flat_s = [_pytree.tree_leaves(s) for s in state_trees]
    for i, (p_, g) in enumerate(zip(flat_p, flat_g)):
        outs = [p_] + [s[i] for s in flat_s]
        views = [t.view(-1) for t in [p_, g] + [s[i] for s in flat_s]]
        for lo in range(0, p_.numel(), _CHUNK):
            part = [v[lo:lo + _CHUNK] for v in views]
            new = rule(scalars, *part)
            for dst, src in zip(outs, new):
                dst.view(-1)[lo:lo + _CHUNK].copy_(src)


def sgd(lr_fn, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        inner = _zeros_like(params, torch.float32) if momentum else None
        return OptState(_step0(params), inner)

    def rule(lr, p_, g, *m):
        if momentum:
            new_m = momentum * m[0] + g.float()
            u = new_m
        else:
            u = g.float()
        pf = p_.float()
        newp = (pf - lr * (u + weight_decay * pf)).to(p_.dtype)
        return (newp, new_m) if momentum else (newp,)

    def states(state):
        return [state.inner] if momentum else []

    def update_(grads, state, params):
        t = state.step + 1
        _in_place(rule, lr_fn(t), grads, states(state), params)
        state.step.copy_(t)

    return Optimizer(init, update_, "sgd")


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype=torch.float32) -> Optimizer:
    """moment_dtype=bfloat16 halves optimizer-state memory (the standard
    large-model tradeoff; updates still computed in fp32)."""
    def init(params):
        return OptState(_step0(params),
                        {"m": _zeros_like(params, moment_dtype),
                         "v": _zeros_like(params, moment_dtype)})

    def scalars(t):
        tf = t.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=t.device), tf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=t.device), tf)
        return lr_fn(t), c1, c2

    def rule(sc, p_, g, m, v):
        lr, c1, c2 = sc
        g = g.float()
        mf = b1 * m.float() + (1 - b1) * g
        vf = b2 * v.float() + (1 - b2) * g * g
        upd = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        pf = p_.float()
        newp = pf - lr * (upd + weight_decay * pf)
        return newp.to(p_.dtype), mf.to(moment_dtype), vf.to(moment_dtype)

    def update_(grads, state, params):
        t = state.step + 1
        _in_place(rule, scalars(t), grads,
                  [state.inner["m"], state.inner["v"]], params)
        state.step.copy_(t)

    return Optimizer(init, update_, "adamw")


def dual_averaging(a_fn, projection: Callable[[PyTree], PyTree] | None = None
                   ) -> Optimizer:
    """DDA primal-dual update (paper eq. 3-4, local part):
        z <- z + g;   x <- Proj(-a(t) z)
    The consensus mixing of z happens outside (the launcher's mix step),
    exactly as the paper separates cheap and expensive iterations."""

    def init(params):
        return OptState(_step0(params),
                        {"z": _zeros_like(params, torch.float32)})

    def rule(a_t, p_, g, z):
        new_z = z + g.float()
        return (-a_t * new_z).to(p_.dtype), new_z

    def update_(grads, state, params):
        t = state.step + 1
        _in_place(rule, a_fn(t), grads, [state.inner["z"]], params)
        if projection is not None:
            new_p = projection(params)
            for dst, src in zip(_pytree.tree_leaves(params),
                                _pytree.tree_leaves(new_p)):
                dst.copy_(src)
        state.step.copy_(t)

    return Optimizer(init, update_, "dual_averaging")
