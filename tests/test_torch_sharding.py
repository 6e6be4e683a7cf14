"""The port's logical sharding rules and abstract specs against the JAX
package's, on the CPU: `runtime.sharding` (`logical_to_spec`, `spec_for`,
`use_rules`, `rules_active`, `constrain`, `tree_specs`) and
`launch.specs` (params, optimizer state, pod-stacked state, batches,
decode caches and decode tokens) for every arch x shape cell on both
production meshes.

The reference's specs need only a mesh's axis names and device-array
shape, so a stand-in mesh serves it and nothing compiles; the port builds
its trees on the meta device. Standard: shapes, dtypes and specs equal
leaf for leaf (a reference `PartitionSpec` as a tuple), the trees
compared by key path.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.launch import specs as ref_sp
from repro.models import registry as ref_registry
from repro.optim import adamw as ref_adamw, cosine_lr as ref_cosine
from repro.runtime import sharding as ref_sh

from repro_torch.launch import specs as port_sp
from repro_torch.launch.mesh import (make_production_mesh, mesh_shape,
                                     num_pods)
from repro_torch.models import registry as port_registry
from repro_torch.optim import adamw as port_adamw, cosine_lr as port_cosine
from repro_torch.runtime import sharding as port_sh

MESHES = {"pod16x16": False, "pod2x16x16": True}


def _ref_mesh(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _ref_tree(tree):
    """A reference tree of ShapeDtypeStructs or PartitionSpecs as nested
    dicts and lists, leaves (shape, dtype) or ("spec", entries)."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return ("spec", tuple(tree))
    if isinstance(tree, dict):
        return {k: _ref_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_ref_tree(v) for v in tree]
    if hasattr(tree, "_fields"):
        return {f: _ref_tree(getattr(tree, f)) for f in tree._fields}
    return (tuple(tree.shape), jnp.dtype(tree.dtype).name)


def _port_tree(tree):
    if tree is None:
        return None
    if port_sp.is_spec_leaf(tree):
        return ("spec", tree)
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_tree(v) for v in tree]
    if hasattr(tree, "_fields"):
        return {f: _port_tree(getattr(tree, f)) for f in tree._fields}
    assert tree.device.type == "meta"
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


def _same(port_pair, ref_pair, label):
    for i, what in enumerate(("trees", "specs")):
        ours, theirs = _port_tree(port_pair[i]), _ref_tree(ref_pair[i])
        assert ours == theirs, f"{label}: {what} differ"


def _optimizers(arch):
    cfg = port_registry.get_config(arch, "full")
    bf16 = cfg.opt_moments_bf16
    return (port_adamw(port_cosine(3e-4, 10000),
                       moment_dtype=torch.bfloat16 if bf16 else torch.float32),
            ref_adamw(ref_cosine(3e-4, 10000),
                      moment_dtype=jnp.bfloat16 if bf16 else jnp.float32))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_cell_specs_match_reference(arch, mesh_name):
    multi_pod = MESHES[mesh_name]
    mesh, ref_mesh = make_production_mesh(multi_pod=multi_pod), \
        _ref_mesh(multi_pod)
    cfg_p = port_registry.get_config(arch, "full")
    cfg_r = ref_registry.get_config(arch, "full")

    params = port_sp.param_specs(cfg_p, mesh)
    ref_params = ref_sp.param_specs(cfg_r, ref_mesh)
    _same(params, ref_params, "params")
    opt_p, opt_r = _optimizers(arch)
    state = port_sp.opt_state_specs(opt_p, *params)
    ref_state = ref_sp.opt_state_specs(opt_r, *ref_params)
    _same(state, ref_state, "optimizer state")
    if multi_pod:
        _same(port_sp.pod_stack_specs(*params, 2),
              ref_sp.pod_stack(*ref_params, 2), "pod-stacked params")
        _same(port_sp.pod_stack_specs(*state, 2),
              ref_sp.pod_stack(*ref_state, 2), "pod-stacked state")

    port_cells = port_registry.get_shapes(arch)
    for name, cell in ref_registry.get_shapes(arch).items():
        ours = port_cells[name]
        assert (ours.seq_len, ours.global_batch, ours.kind, ours.skip) == (
            cell.seq_len, cell.global_batch, cell.kind, cell.skip)
        if cell.kind in ("train", "prefill"):
            for consensus in (False, True):
                _same(port_sp.batch_specs(cfg_p, ours, mesh,
                                          consensus=consensus),
                      ref_sp.batch_specs(cfg_r, cell, ref_mesh,
                                         consensus=consensus),
                      f"{name} batch (consensus={consensus})")
        else:
            _same(port_sp.cache_specs(cfg_p, ours, mesh),
                  ref_sp.cache_specs(cfg_r, cell, ref_mesh),
                  f"{name} cache")
            _same(port_sp.decode_token_specs(ours, mesh),
                  ref_sp.decode_token_specs(cell, ref_mesh),
                  f"{name} decode tokens")


def test_composite_axis_and_replicated_tokens():
    """The decode cache's batch over ("pod", "data") jointly, and the
    B = 1 cell's tokens replicated, on the multi-pod mesh."""
    mesh = make_production_mesh(multi_pod=True)
    cfg = port_registry.get_config("zamba2-2.7b", "full")
    cells = port_registry.get_shapes("zamba2-2.7b")
    _, cspecs = port_sp.cache_specs(cfg, cells["decode_32k"], mesh)
    batch_entries = {s[1] for s in port_sp.spec_leaves(cspecs)}
    assert batch_entries == {("pod", "data")}
    _, tspecs = port_sp.decode_token_specs(cells["decode_32k"], mesh)
    assert tspecs["tokens"] == (("pod", "data"),)
    long = cells["long_500k"]
    assert long.global_batch == 1 and long.skip is None
    _, tspecs = port_sp.decode_token_specs(long, mesh)
    assert tspecs == {"tokens": (), "pos": ()}
    assert port_sp._spec_size((("pod", "data"), None), mesh) == 32


def test_production_mesh_is_a_layout_on_meta():
    for multi_pod, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.shape == shape and mesh.device.type == "meta"
        assert mesh.size == int(np.prod(shape)) and mesh.group is None
        ref = _ref_mesh(multi_pod)
        assert mesh_shape(mesh) == dict(zip(ref.axis_names,
                                            ref.devices.shape))
        assert num_pods(mesh) == (2 if multi_pod else 1)


CASES = [
    # (shape, logical axes): competing axes, divisibility, priorities
    ((4096, 14336), ("embed", "mlp")),
    ((8, 128), ("kv_heads", "head")),
    ((128, 32768, 8, 128), ("batch", "cache_seq", "kv_heads", "head")),
    ((1, 32768, 8, 128), ("batch", "cache_seq", "kv_heads", "head")),
    ((32, 4096, 4096), ("layers", "embed", "q_heads")),
    ((160, 5120, 1536), ("experts", "embed", "expert_mlp")),
    ((7, 15), ("embed", "vocab")),
    ((64, 64), (None, "mlp")),
    ((16, 16), ("seq_sp", "vocab")),
]


@pytest.mark.parametrize("shape,axes", CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_to_spec_matches_reference(shape, axes, mesh_name):
    ref = _ref_mesh(MESHES[mesh_name])
    sizes = dict(zip(ref.axis_names, ref.devices.shape))
    want = tuple(ref_sh.logical_to_spec(shape, axes, ref_sh.DEFAULT_RULES,
                                        sizes))
    assert port_sh.logical_to_spec(shape, axes, port_sh.DEFAULT_RULES,
                                   sizes) == want
    assert port_sh.DEFAULT_RULES == ref_sh.DEFAULT_RULES
    assert port_sh._ASSIGN_PRIORITY == ref_sh._ASSIGN_PRIORITY


def test_use_rules_nests_restores_and_constrain_is_the_identity():
    outer = make_production_mesh(multi_pod=False)
    inner = make_production_mesh(multi_pod=True)
    x = torch.empty((4096, 14336), device="meta")
    assert not port_sh.rules_active()
    with port_sh.use_rules(port_sh.DEFAULT_RULES, outer):
        assert port_sh.rules_active()
        assert port_sh.spec_for(x, ("embed", "mlp")) == ("data", "model")
        custom = dict(port_sh.DEFAULT_RULES, embed=(), mlp=("data",))
        with port_sh.use_rules(custom, inner):
            assert port_sh.spec_for(x, ("embed", "mlp")) == (None, "data")
        assert port_sh.spec_for(x, ("embed", "mlp")) == ("data", "model")
        assert port_sh.constrain(x, ("embed", "mlp")) is x
    assert not port_sh.rules_active()
    with pytest.raises(RuntimeError):
        with port_sh.use_rules(port_sh.DEFAULT_RULES, outer):
            raise RuntimeError("inside")
    assert not port_sh.rules_active()
    y = torch.ones(3)
    assert port_sh.constrain(y, ("embed",)) is y


def test_tree_specs_is_the_references_per_leaf():
    mesh = make_production_mesh(multi_pod=False)
    tree = {"a": torch.empty((4096, 1024), device="meta"),
            "b": [torch.empty((8, 3), device="meta")]}
    axes = {"a": ("embed", "mlp"), "b": [("kv_heads", None)]}
    assert port_sh.tree_specs(tree, axes, mesh) == {
        "a": ("data", "model"), "b": [(None, None)]}
    with pytest.raises(ValueError, match="leaves against"):
        port_sh.tree_specs(tree, {"a": ("embed", "mlp"), "b": []}, mesh)
