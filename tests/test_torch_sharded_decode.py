"""Sharded inference on the CPU: `make_prefill_step` and `make_serve_step`
on a serving mesh of four gloo ranks (`tests/_ranks.py`, one thread
each), DTensor parameters, batches, caches and tokens placed by
`launch.specs.serve_placements`, against the reference's jitted steps
under its rules with the dry-run's `in_shardings` on 4 host devices in a
subprocess. The four ranks and the reference's subprocess each run once
for the module.

Every case: float32 smoke configs, the port's init from seed 0 perturbed
by seeded noise (`_decode.perturbed`: non-zero cross-attention gates),
numpy-seeded tokens, B = 2, prefill at S = 16, then 16 teacher-forced
serve steps from position 0 over a float32 cache of max_seq 16, so the
writes cross every shard boundary (`pos` an int at even steps, a 0-d
tensor at odd ones). The layouts (`CASES`):
  * llama3-8b at (data 2, model 2): kv-head shards, the batch over data;
  * llama3-8b at (1, 4): head-dim shards (the production layout: 8 kv
    heads do not divide model 16);
  * deepseek-v2 at (2, 2): MLA's latent cache sharded over its sequence
    and its rope key over its head dim; the MoE at one group;
  * llama-3.2-vision-90b at (2, 2): the cross cache over `enc_tokens`;
  * falcon-mamba-7b and zamba2-2.7b at (2, 2): the conv and SSM states
    over `ssm_inner` / `ssm_heads`;
  * llama3-8b at (pod 2, data 1, model 2): the pods as data ranks.

Standards:
  * each step's logits, the final cache and the prefill logits within
    `F32_TOL` = 1e-5 of their largest magnitude against the reference's
    (the standard of `tests/test_torch_decode_models.py`; observed at
    most 2.3e-6, deepseek-v2's decode logits; the rest at most 1.5e-6);
  * every rank's gathered tensors equal bit for bit;
  * no serve step gathers a cache or a weight: no all-gather of one step
    takes in a tensor of a cache shard's shape, or of a parameter
    shard's (or a view merging adjacent dims of one: decode's products
    meet the weights where they lie, `runtime.sharding.project`) (the
    collectives recorded by `launch.dryrun.CollectiveBytes`, those
    DTensor issues inside an op included), and each cache lies as the
    rules place it. The bytes a step all-gathers (output bytes, a few
    tokens' activations) still pass one rank's cache-shard bytes in
    five of the seven layouts (llama3-8b's kv-head layout 19,472 B
    against 4,096 B; 116,240 B before the weights stayed in place), so
    the shapes are the test;
  * the reference's own gate (`tests/test_models.py`
    test_decode_matches_forward) with the decode on the sharded path at
    (2, 2): its inputs (S = 8, tokens from PRNGKey(7), encoder states
    from PRNGKey(0)), bf16 weights, a float32 cache, drop-free MoE
    capacity, atol 0.13 and rtol 0.1 (observed at most 0.074,
    deepseek-v2);
  * `_write_at` over a sequence-sharded cache writes only in the shard
    holding `pos` (the fault by which deepseek-v2's sharded decode was
    4.25 off before it wrote where the cache lies);
  * on one rank (data 1, model 1: the card's layout in `chip_smoke.py`)
    the DTensor path equals the plain one bit for bit for every arch in
    float32 and bf16, its parameters placed without a copy.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.compress import prng
from repro_torch.convert import lm_params_to_reference
from repro_torch.models import registry
from repro_torch.models import transformer as port_tf

import _ranks
from _decode import perturbed
from test_torch_distributed import _reference, _result

F32_TOL = 1e-5
#: the reference's gate (tests/test_models.py), bf16 weights over a
#: float32 cache
GATE_TOL = dict(atol=0.13, rtol=0.1)
B, S = 2, 16
DM = ("data", "model")
#: case -> (arch, mesh axes, mesh shape)
CASES = {
    "llama3_kv_heads": ("llama3-8b", DM, (2, 2)),
    "llama3_head_dim": ("llama3-8b", DM, (1, 4)),
    "deepseek_mla": ("deepseek-v2-236b", DM, (2, 2)),
    "vision_cross": ("llama-3.2-vision-90b", DM, (2, 2)),
    "falcon_mamba": ("falcon-mamba-7b", DM, (2, 2)),
    "zamba2_hybrid": ("zamba2-2.7b", DM, (2, 2)),
    "llama3_pods": ("llama3-8b", ("pod", "data", "model"), (2, 1, 2)),
}
#: the cache leaves each case holds to its layout: leaf -> the stacked
#: (layers, B, T, ...) leaf's placements on the (data, model) DeviceMesh
LAYOUTS = {
    "llama3_kv_heads": {"stack/slot0/k": ["S1", "S3"]},
    "llama3_head_dim": {"stack/slot0/k": ["R", "S4"]},
    "deepseek_mla": {"prologue/0/ckv": ["S0", "S1"],
                     "prologue/0/krope": ["S0", "S2"],
                     "stack/slot0/ckv": ["S1", "S2"],
                     "stack/slot0/krope": ["S1", "S3"]},
    "vision_cross": {"stack/slot0/k": ["S1", "S3"],
                     "stack/slot2/ek": ["S1", "S2"]},
    "falcon_mamba": {"stack/slot0/conv": ["S1", "S3"],
                     "stack/slot0/h": ["S1", "S2"]},
    "zamba2_hybrid": {"stack/slot0/conv": ["S1", "S3"],
                      "stack/slot0/h": ["S1", "S2"],
                      "stack/slot2/k": ["S1", "S3"]},
    "llama3_pods": {"stack/slot0/k": ["S1", "S3"]},
}
GATE_ARCHS = ["llama3-8b", "deepseek-v2-236b", "falcon-mamba-7b",
              "zamba2-2.7b", "llama-3.2-vision-90b"]
#: the reference gate's sequence (tokens from PRNGKey(7), as its own)
GATE_SEQ = 8
#: the serve step whose collectives are recorded
RECORD_POS = 9

_REF_SCRIPT = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.shapes import ShapeCell
from repro.launch import specs as sp
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_prefill_step, make_serve_step
from repro.models import registry, transformer
from repro.runtime import sharding as sh

args = json.loads(sys.argv[1])
arrays = np.load(args["path"])


def names(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    got = {}
    for k, v in items:
        got.update(names(v, f"{prefix}/{k}" if prefix else str(k)))
    return got


def filled(tree, prefix):
    if isinstance(tree, dict):
        return {k: filled(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [filled(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return jnp.asarray(arrays[prefix])


saved = {}
for case, (arch, axes, shape) in args["cases"].items():
    cfg = dataclasses.replace(registry.get_config(arch, "smoke"),
                              dtype=jnp.float32)
    mesh = make_mesh(tuple(shape), tuple(axes))
    tokens = arrays[f"{arch}/tokens"]
    B, S = tokens.shape
    groups = dict(zip(axes, shape)).get("data", 1) if cfg.moe_experts else 1
    with sh.use_rules(sh.DEFAULT_RULES, mesh), mesh:
        abstract, pspecs = sp.param_specs(cfg, mesh)
        params = filled(abstract, f"{arch}/params")
        _, bspecs = sp.batch_specs(cfg, ShapeCell("p", S, B, "prefill"),
                                   mesh, consensus=False)
        batch = {"tokens": jnp.asarray(tokens)}
        if cfg.family == "vlm":
            batch["enc"] = jnp.asarray(arrays[f"{arch}/enc"])
        bspecs = {k: bspecs[k] for k in batch}
        prefill = jax.jit(make_prefill_step(cfg, groups),
                          in_shardings=sp.to_shardings((pspecs, bspecs),
                                                       mesh))
        saved[f"{case}/prefill"] = np.asarray(prefill(params, batch))
        cell = ShapeCell("d", S, B, "decode")
        _, cspecs = sp.cache_specs(cfg, cell, mesh)
        _, tspecs = sp.decode_token_specs(cell, mesh)
        cache = transformer.init_cache(cfg, B, S, jnp.float32)
        if cfg.family == "vlm":
            stack = dict(cache["stack"])
            for i, kind in enumerate(cfg.superblock):
                if kind == "cross_attn":
                    prm = params["stack"][f"slot{i}"]["attn"]
                    stack[f"slot{i}"] = {
                        "ek": jnp.einsum("lehk,bne->lbnhk", prm["wk"],
                                         batch["enc"]),
                        "ev": jnp.einsum("lehk,bne->lbnhk", prm["wv"],
                                         batch["enc"])}
            cache = {**cache, "stack": stack}
        in_sh = sp.to_shardings((pspecs, cspecs, tspecs["tokens"],
                                 tspecs["pos"]), mesh)
        serve = jax.jit(make_serve_step(cfg, moe_groups=1),
                        in_shardings=in_sh)
        logits = []
        for pos in range(S):
            # the step's cache comes back as XLA laid it out: placed again
            cache = jax.device_put(cache, in_sh[1])
            lg, cache = serve(params, cache,
                              jnp.asarray(tokens[:, pos:pos + 1]),
                              jnp.int32(pos))
            logits.append(np.asarray(lg)[:, 0])
        saved[f"{case}/logits"] = np.stack(logits, axis=1)
        for n, v in names(cache).items():
            saved[f"{case}/cache/{n}"] = np.asarray(v)
np.savez(args["out"], **saved)
print("RESULT " + json.dumps(sorted(args["cases"])))
"""


def _arrays(path) -> None:
    """Each arch's float32 parameters (the port's init from seed 0 plus
    seeded noise), tokens (B, S) and, for the VLM, encoder states, named
    as `_ranks.tree_names` names them, written to `path` (both packages
    read them)."""
    rng = np.random.default_rng(27)
    arrays = {}
    for arch in sorted({arch for arch, _, _ in CASES.values()}):
        cfg = dataclasses.replace(registry.get_config(arch, "smoke"),
                                  dtype=torch.float32)
        params = perturbed(jax.tree.map(jnp.asarray, lm_params_to_reference(
            port_tf.init(prng.key(0, "cpu"), cfg)[0])), 0)
        for name, leaf in _ranks.tree_names(params).items():
            arrays[f"{arch}/params/{name}"] = np.asarray(leaf)
        arrays[f"{arch}/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        if cfg.family == "vlm":
            arrays[f"{arch}/enc"] = rng.normal(size=(
                B, cfg.num_encoder_tokens, cfg.encoder_dim)).astype(
                np.float32)
    for arch in GATE_ARCHS:  # the reference gate's own inputs
        cfg = registry.get_config(arch, "smoke")
        arrays[f"gate/{arch}/tokens"] = np.asarray(jax.random.randint(
            jax.random.PRNGKey(7), (B, GATE_SEQ), 0, cfg.vocab_size))
        if cfg.family == "vlm":
            arrays[f"gate/{arch}/enc"] = np.asarray(jax.random.normal(
                jax.random.PRNGKey(0), (B, cfg.num_encoder_tokens,
                                        cfg.encoder_dim)).astype(
                jnp.bfloat16).astype(jnp.float32))
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's jitted sharded steps (4 host devices) and the port's
    on four ranks: every case, the gate, the write case."""
    return _runs(tmp_path_factory.mktemp("sharded_decode"))


def _runs(tmp):
    _arrays(tmp / "inputs.npz")
    cases = {k: [a, list(axes), list(shape)]
             for k, (a, axes, shape) in CASES.items()}
    ref = _reference(_REF_SCRIPT, 4, json.dumps({
        "path": str(tmp / "inputs.npz"), "cases": cases,
        "out": str(tmp / "reference.npz")}))
    try:
        ranks = _ranks.spawn(_ranks.serving, 4, {
            "path": str(tmp / "inputs.npz"), "cases": cases,
            "record_pos": RECORD_POS,
            "gate": {"archs": GATE_ARCHS, "mesh": [list(DM), [2, 2]]}},
            timeout=600)
    except BaseException:
        ref.kill()
        ref.wait()
        raise
    _result(ref, timeout=600)
    arrays = np.load(tmp / "reference.npz")
    return {"reference": {k: arrays[k] for k in arrays.files},
            "ranks": ranks}


def _rel(ours: np.ndarray, ref: np.ndarray) -> float:
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_reference(runs, case):
    ours = runs["ranks"][0]["cases"][case]["prefill"]
    assert ours.shape == (B, registry.get_config(CASES[case][0],
                                                 "smoke").vocab_size)
    assert _rel(ours, runs["reference"][f"{case}/prefill"]) <= F32_TOL


@pytest.mark.parametrize("case", CASES)
def test_decode_logits_match_reference(runs, case):
    got = runs["ranks"][0]["cases"][case]
    ref = runs["reference"][f"{case}/logits"]
    worst = max(_rel(got["logits"][:, t], ref[:, t]) for t in range(S))
    assert worst <= F32_TOL, worst
    # the reference's ("batch", "seq", "vocab"): rows over the data ranks
    # (the pods with them), the vocabulary over 'model'
    _, axes, shape = CASES[case]
    sizes = dict(zip(axes, shape))
    rows = sizes.get("pod", 1) * sizes["data"] > 1
    assert got["logits_placements"] == [
        "S0" if rows else "R", "S2"]


@pytest.mark.parametrize("case", CASES)
def test_final_cache_matches_reference(runs, case):
    got = runs["ranks"][0]["cases"][case]["cache"]
    ref = {k[len(f"{case}/cache/"):]: v for k, v in runs["reference"].items()
           if k.startswith(f"{case}/cache/")}
    assert got.keys() == ref.keys()
    for name, leaf in got.items():
        assert _rel(leaf, ref[name]) <= F32_TOL, name


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree_bit_for_bit(runs, case):
    digests = [r["cases"][case]["digests"] for r in runs["ranks"]]
    assert all(d == digests[0] for d in digests[1:])


@pytest.mark.parametrize("case", CASES)
def test_no_serve_step_gathers_a_cache(runs, case):
    """No all-gather of one serve step, on any rank, takes in a tensor of
    a cache shard's shape (a leaf's local shard or a layer's view of it),
    nor of a parameter shard's (a sharded leaf's local shard, a layer's
    view of it, or a view merging adjacent dims of these: decode's
    products meet the weights where they lie); the cache leaves lie as
    the rules place them (so the writes and the attention met each
    layout the case names)."""
    for rank in runs["ranks"]:
        got = rank["cases"][case]
        shards = got["cache_shard_shapes"]
        assert got["gathered_shapes"], got["collectives"]
        hit = [s for s in got["gathered_shapes"] if s in shards]
        assert not hit, (hit, got["collectives"])
        params = got["param_shard_shapes"]
        assert params
        hit = [s for s in got["gathered_shapes"] if s in params]
        assert not hit, (hit, got["collectives"])
    placements = runs["ranks"][0]["cases"][case]["cache_placements"]
    for leaf, want in LAYOUTS[case].items():
        assert placements[leaf] == want, (leaf, placements[leaf])


@pytest.mark.parametrize("arch", GATE_ARCHS)
def test_sharded_decode_matches_forward(runs, arch):
    """The reference's gate on the port's sharded decode."""
    gate = runs["ranks"][0]["gate"][arch]
    assert np.isfinite(gate["decode"]).all()
    np.testing.assert_allclose(gate["decode"], gate["forward"], **GATE_TOL)


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process and its serving mesh (data 1,
    model 1): the layout the card runs."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_serve_mesh((1, 1), DM, group=dist.group.WORLD,
                              device="cpu")
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("shape,match", [
    ((2, 2, 1), "folds its 2 pods into the data ranks"),
    ((1, 2, 2), "1 ranks but the serving mesh")])
def test_serve_mesh_refusals(one_rank, shape, match):
    """Pods beside a data axis of several ranks, and a group of another
    size than the mesh, are refused."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh

    with pytest.raises(ValueError, match=match):
        make_serve_mesh(shape, ("pod", "data", "model"),
                        group=dist.group.WORLD, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_one_rank_dtensor_path_is_the_plain_path(one_rank, arch, dtype):
    """On one rank (`chip_smoke.py`'s layout) the DTensor path is the
    plain one bit for bit: the parameters placed without a copy, the
    prefill's logits, each serve step's and the cache after them."""
    import torch.utils._pytree as pytree

    from repro_torch.launch import specs as sp
    from repro_torch.launch import steps
    from repro_torch.runtime import sharding as sh

    cfg = dataclasses.replace(registry.get_config(arch, "smoke"),
                              dtype=getattr(torch, dtype))
    params = port_tf.init(prng.key(0, "cpu"), cfg)[0]
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, 8), generator=gen)
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["enc"] = torch.randn((B, cfg.num_encoder_tokens,
                                    cfg.encoder_dim),
                                   generator=gen).to(cfg.dtype)
    dm = one_rank.device_mesh
    pl = sp.serve_placements(cfg, one_rank, B, 8, 8)
    d_params = sh.place(params, pl["params"], dm)
    assert all(d.to_local().data_ptr() == t.data_ptr() for d, t in zip(
        pytree.tree_leaves(d_params), pytree.tree_leaves(params)))
    d_batch = sh.place(batch, {k: pl["batch"][k] for k in batch}, dm)
    assert torch.equal(
        steps.make_prefill_step(cfg, mesh=one_rank)(d_params,
                                                    d_batch).to_local(),
        steps.make_prefill_step(cfg)(params, batch))
    cache = port_tf.init_cache(cfg, B, 8, torch.float32, device="cpu")
    d_cache = port_tf.init_cache(cfg, B, 8, torch.float32, device="cpu")
    placed = sh.place(d_cache, pl["cache"], dm)
    d_tokens = sh.cut(tokens, dm, pl["tokens"])
    serve = steps.make_serve_step(cfg)
    d_serve = steps.make_serve_step(cfg, mesh=one_rank)
    for pos in range(8):
        logits, cache = serve(params, cache, tokens[:, pos:pos + 1], pos)
        d_logits, placed = d_serve(d_params, placed,
                                   d_tokens[:, pos:pos + 1], pos)
        assert torch.equal(d_logits.to_local(), logits), pos
    for a, b in zip(pytree.tree_leaves(d_cache), pytree.tree_leaves(cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["int", "tensor"])
def test_write_lands_in_the_shard_holding_pos(runs, form):
    for rank in runs["ranks"]:
        assert rank["write"][form] == {"equal": True, "local": True}


#: each case's all-gathered bytes a step before decode's products met
#: the weights where they lie (ROADMAP queue 3)
ALL_GATHERED_BEFORE = {"llama3_kv_heads": 116240,
                       "llama3_head_dim": 73728, "deepseek_mla": 183568,
                       "vision_cross": 311824, "falcon_mamba": 17936,
                       "zamba2_hybrid": 260752, "llama3_pods": 2064}


def _report(runs) -> dict:
    """The observed errors and bytes the standards above quote, each
    case's all-gathered bytes beside those before decode's products met
    the weights where they lie."""
    ref, ours = runs["reference"], runs["ranks"][0]
    out = {}
    for case in CASES:
        got = ours["cases"][case]
        out[case] = {
            "prefill": _rel(got["prefill"], ref[f"{case}/prefill"]),
            "logits": max(_rel(got["logits"][:, t], ref[f"{case}/logits"][
                :, t]) for t in range(S)),
            "cache": max(_rel(v, ref[f"{case}/cache/{k}"])
                         for k, v in got["cache"].items()),
            "all_gathered_bytes": max(
                r["cases"][case]["collectives"].get("all-gather", 0)
                for r in runs["ranks"]),
            "all_gathered_bytes_before": ALL_GATHERED_BEFORE[case],
            "cache_shard_bytes": got["cache_shard_bytes"]}
    out["gate_max_abs"] = {
        arch: float(np.abs(g["decode"] - g["forward"]).max())
        for arch, g in ours["gate"].items()}
    return out


if __name__ == "__main__":  # the observed values: python tests/<this file>
    import pathlib
    import sys
    import tempfile

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(_report(_runs(pathlib.Path(tmp))), indent=1))
