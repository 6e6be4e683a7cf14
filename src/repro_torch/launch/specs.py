"""Pod-stacked state and abstract input specs, the port of
`repro.launch.specs`.

For consensus (multi-pod) training, model and optimizer state carry a
leading `pod` replica dimension: each pod is one DDA node with its own
parameters, and the batch is split across pods (disjoint data shards,
paper section II). `pod_stack` stacks concrete pods on one device.

The rest builds every (architecture x input-shape) cell's step arguments
as meta tensors (shapes and dtypes, no memory: the counterpart of the
reference's `ShapeDtypeStruct`s from `jax.eval_shape`), from the port's
own `transformer.init`, `init_cache`, `cache_axes` and `optimizer.init`,
each beside its spec (`runtime.sharding`: a tuple, one entry per
dimension). The dry-run (`launch/dryrun.py`) reckons per-device bytes
from them; `placements` turns them into DTensor placements (the
reference's `to_shardings`), by which `launch.train` places a sharded
pod's parameters, optimizer state and batches (`train_placements`), and
inference its parameters, batches, caches and tokens
(`serve_placements`, under `serve_rules`).
"""

from __future__ import annotations

import math
from typing import Any, Iterable

import torch
import torch.utils._pytree as _pytree

from repro_torch.compress import prng
from repro_torch.configs.shapes import ShapeCell
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.optim import Optimizer
from repro_torch.runtime import sharding as shrules

PyTree = Any
META = torch.device("meta")


def is_spec_leaf(x) -> bool:
    """A spec: a tuple whose entries are axis names, None or tuples of
    names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def spec_leaves(specs: PyTree) -> list:
    return _pytree.tree_leaves(specs, is_leaf=is_spec_leaf)


def pod_stack(pods: Iterable[PyTree], n_pods: int) -> PyTree:
    """Stack `n_pods` trees of one structure into one tree of (n_pods, ...)
    leaves. `pods` may be a generator: each pod's tree is copied into the
    stack and dropped before the next one is made, so only one pod's tree
    is alive beside the stack."""
    stacked, spec = None, None
    count = 0
    for i, tree in enumerate(pods):
        leaves, tree_spec = _pytree.tree_flatten(tree)
        if stacked is None:
            spec = tree_spec
            stacked = [torch.empty((n_pods,) + tuple(leaf.shape),
                                   dtype=leaf.dtype, device=leaf.device)
                       for leaf in leaves]
        elif tree_spec != spec:
            raise ValueError(f"pod {i}'s tree differs from pod 0's")
        for dst, leaf in zip(stacked, leaves):
            dst[i].copy_(leaf)
        count += 1
        del tree, leaves
    if count != n_pods:
        raise ValueError(f"{count} pod trees for n_pods={n_pods}")
    return _pytree.tree_unflatten(stacked, spec)


def pod_stack_specs(tree: PyTree, specs: PyTree, n_pods: int
                    ) -> tuple[PyTree, PyTree]:
    """The spec form of `pod_stack` (the reference's `pod_stack`): every
    meta leaf gains a leading pod dimension, sharded over 'pod'. None (the
    state of SGD without momentum) stays None."""
    def stack(t):
        return torch.empty((n_pods,) + tuple(t.shape), dtype=t.dtype,
                           device=META)
    flat, treedef = _pytree.tree_flatten(tree)
    stacked = _pytree.tree_unflatten(
        [None if t is None else stack(t) for t in flat], treedef)
    sflat, sdef = _pytree.tree_flatten(specs, is_leaf=is_spec_leaf)
    return stacked, _pytree.tree_unflatten(
        [None if s is None else ("pod",) + s for s in sflat], sdef)


def param_bytes_per_pod(stacked: PyTree, n_pods: int) -> float:
    """Bytes one pod ships per gossip round per link: the pod-stacked
    parameter tree's bytes over the pods, as the reference's launcher
    divides them (a float)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in _pytree.tree_leaves(stacked)) / max(n_pods, 1)


def params_and_axes(cfg: ModelConfig) -> tuple[PyTree, PyTree]:
    """Abstract params (meta tensors, no allocation) and their logical
    axes, from `transformer.init` on a meta key."""
    return transformer.init(prng.key(0, META), cfg)


def param_specs(cfg: ModelConfig, mesh) -> tuple[PyTree, PyTree]:
    """(abstract params, specs) -- no pod dimension."""
    params, axes = params_and_axes(cfg)
    return params, shrules.tree_specs(params, axes, mesh)


def opt_state_specs(optimizer: Optimizer, abstract_params: PyTree,
                    param_specs_tree: PyTree) -> tuple[PyTree, PyTree]:
    """Abstract optimizer state + specs: moment tensors inherit the param
    specs; scalar counters are replicated."""
    state = optimizer.init(abstract_params)
    leaves_s = spec_leaves(param_specs_tree)
    n_params = len(_pytree.tree_leaves(abstract_params))

    def specs_like(subtree):
        flat, treedef = _pytree.tree_flatten(subtree)
        if len(flat) == n_params:
            return _pytree.tree_unflatten(leaves_s, treedef)
        return _pytree.tree_unflatten([()] * len(flat), treedef)

    if state.inner is None:
        inner_specs = None
    elif isinstance(state.inner, dict):
        inner_specs = {k: specs_like(v) for k, v in state.inner.items()}
    else:
        inner_specs = specs_like(state.inner)
    return state, type(state)(step=(), inner=inner_specs)


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                *, consensus: bool) -> tuple[PyTree, PyTree]:
    """Training/prefill batch: tokens+labels (+enc for VLM)."""
    sizes = shrules.mesh_axis_sizes(mesh)
    has_pod = "pod" in mesh.axis_names
    B, S = cell.global_batch, cell.seq_len
    if has_pod and consensus:
        n_pods = sizes["pod"]
        lead, batch_spec = (n_pods,), ("pod", "data", None)
        B = B // n_pods
    elif has_pod:
        lead, batch_spec = (), (("pod", "data"), None)
    else:
        lead, batch_spec = (), ("data", None)
    batch = {name: torch.empty(lead + (B, S), dtype=torch.int32,
                               device=META)
             for name in ("tokens", "labels")}
    spec = {"tokens": batch_spec, "labels": batch_spec}
    if cfg.family == "vlm":
        batch["enc"] = torch.empty(
            lead + (B, cfg.num_encoder_tokens, cfg.encoder_dim),
            dtype=cfg.dtype, device=META)
        spec["enc"] = batch_spec[:len(lead) + 1] + (None, None)
    return batch, spec


def placements(specs: PyTree, device_mesh) -> PyTree:
    """The DTensor placements of a tree of specs on `device_mesh`
    (`runtime.sharding.to_placements`, leaf for leaf; None stays None).
    A stacked tree's "pod" entry shards the pod dimension on a (pod, data,
    model) DeviceMesh and leaves it whole (the pods stacked on the rank)
    on a (data, model) one."""
    flat, treedef = _pytree.tree_flatten(
        specs, is_leaf=lambda x: x is None or is_spec_leaf(x))
    return _pytree.tree_unflatten(
        [None if s is None else shrules.to_placements(s, device_mesh)
         for s in flat], treedef)


def train_placements(cfg: ModelConfig, optimizer: Optimizer, mesh,
                     batch: tuple[int, int]) -> tuple[PyTree, PyTree, tuple]:
    """(param placements, optimizer-state placements, batch placements)
    of consensus training's pod-stacked state on `mesh.shard_mesh`: the
    specs of `param_specs` and `opt_state_specs`, stacked
    (`pod_stack_specs`), and of a pod-stacked (n, B, S) token batch (the
    rows over 'data' where B divides), each through `placements`."""
    n_pods = shrules.mesh_axis_sizes(mesh).get("pod", 1)
    aparams, pspecs = param_specs(cfg, mesh)
    astate, sspecs = opt_state_specs(optimizer, aparams, pspecs)
    _, pspecs = pod_stack_specs(aparams, pspecs, n_pods)
    _, sspecs = pod_stack_specs(astate, sspecs, n_pods)
    bspec = ("pod",) + shrules.logical_to_spec(
        batch, ("batch", "seq"), shrules.DEFAULT_RULES,
        shrules.mesh_axis_sizes(mesh))
    dm = mesh.shard_mesh
    return (placements(pspecs, dm), placements(sspecs, dm),
            shrules.to_placements(bspec, dm))


def serve_rules(mesh) -> dict:
    """The rules inference runs under: the defaults, with the batch over
    ('pod', 'data') jointly when the mesh has a pod axis (serving
    replicates the parameters across pods; pods are extra data
    parallelism)."""
    rules = dict(shrules.DEFAULT_RULES)
    if "pod" in mesh.axis_names:
        rules["batch"] = (("pod", "data"),)  # composite axis
    return rules


def serve_placements(cfg: ModelConfig, mesh, batch: int, seq: int,
                     max_seq: int) -> dict:
    """DTensor placements on `mesh.device_mesh` (`launch.mesh.
    make_serve_mesh`) of inference's arguments, as the reference's dry-run
    places its prefill and decode cells (its `in_shardings`): "params"
    (`param_specs`: no pod dimension, so replicated over the pods),
    "batch" (the prefill batch of `batch` rows of `seq` tokens,
    `batch_specs(consensus=False)`, "enc" included for the VLM), "cache"
    (`cache_specs` at `max_seq`), "tokens" and "pos"
    (`decode_token_specs`). Rows go over ('pod', 'data') with a pod axis,
    else over 'data'; a batch whose rows do not divide over them is
    replicated, as `decode_token_specs` replicates B = 1."""
    prefill = ShapeCell("serve_prefill", seq, batch, "prefill")
    decode = ShapeCell("serve_decode", max_seq, batch, "decode")
    _, pspecs = param_specs(cfg, mesh)
    _, bspecs = batch_specs(cfg, prefill, mesh, consensus=False)
    if batch % _spec_size(bspecs["tokens"][:1], mesh) != 0:
        bspecs = {k: (None,) * len(v) for k, v in bspecs.items()}
    _, cspecs = cache_specs(cfg, decode, mesh)
    _, tspecs = decode_token_specs(decode, mesh)
    dm = mesh.device_mesh
    return {"params": placements(pspecs, dm),
            "batch": placements(bspecs, dm),
            "cache": placements(cspecs, dm),
            "tokens": shrules.to_placements(tspecs["tokens"], dm),
            "pos": shrules.to_placements(tspecs["pos"], dm)}


def cache_specs(cfg: ModelConfig, cell: ShapeCell, mesh
                ) -> tuple[PyTree, PyTree]:
    """Decode cache: abstract tree + specs, under `serve_rules` (the batch
    over ('pod', 'data') jointly when a pod axis exists)."""
    B, S = cell.global_batch, cell.seq_len
    cache = transformer.init_cache(cfg, B, S, torch.bfloat16, device=META)
    return cache, shrules.tree_specs(cache, transformer.cache_axes(cfg), mesh,
                                     serve_rules(mesh))


def decode_token_specs(cell: ShapeCell, mesh) -> tuple[PyTree, PyTree]:
    B = cell.global_batch
    spec = (("pod", "data"),) if "pod" in mesh.axis_names else ("data",)
    if B % _spec_size(spec, mesh) != 0:
        spec = ()  # tiny batches (long_500k B=1): replicate
    tok = torch.empty((B, 1), dtype=torch.int32, device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)
    return {"tokens": tok, "pos": pos}, {"tokens": spec, "pos": ()}


def _spec_size(spec: tuple, mesh) -> int:
    mesh_shape = shrules.mesh_axis_sizes(mesh)
    n = 1
    for part in spec:
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            n *= mesh_shape.get(ax, 1)
    return n


def shard_bytes(t: torch.Tensor, spec: tuple, mesh) -> int:
    """Bytes of one device's shard of `t` under `spec`: each sharded
    dimension divided by its axes' size (rounded up, as XLA pads an uneven
    shard)."""
    mesh_shape = shrules.mesh_axis_sizes(mesh)
    n = 1
    for i, d in enumerate(t.shape):
        part = spec[i] if i < len(spec) else None
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        n *= -(-d // math.prod(mesh_shape.get(a, 1) for a in axes))
    return n * t.element_size()

