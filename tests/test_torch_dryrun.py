"""The port's production dry-run (`repro_torch.launch.dryrun`) against the
JAX package's, on the CPU.

The reference lowers and compiles a cell for 512 placeholder devices (in a
subprocess: its module sets the device count before jax starts) and
reads XLA's `memory_analysis()`; the port reckons the same arguments'
per-device bytes from its specs on the meta device, and counts rank 0's
collectives by running one pod's step as meta DTensors over a
placeholder process group. Standards:
  * `argument_size_in_bytes` equal exactly, on the four cells below (the
    prefill cell's `labels`, which its step never reads, left out on both
    sides);
  * `collectives` under the reference's kinds (and `pod_mix`); the port's
    bytes are not XLA's (DTensor and GSPMD choose their collectives
    otherwise, and XLA's HLO text holds a loop's collectives once), so
    they are printed beside XLA's, not held to them;
  * a small case's collectives over 'data' equal a count by hand from
    the placements exactly;
  * the temporaries (`StepMemory`): a two-layer step's peaks, with and
    without checkpoints, and one all-gather's call and bytes equal a
    count by hand exactly; the counts at `DEPTHS` extended to a deeper
    step equal a direct count there exactly (a dense and the hybrid
    smoke arch, a train and a decode step, and a train step whose
    largest leaf changes past the `DEPTHS`); the compared train and
    prefill cells' temporaries at most `TEMP_OVER_XLA` = 1.25 times
    XLA's, zamba2's decode cell and every cell's collective calls
    printed beside XLA's, not held to them; the record's
    `bytes_per_device` is the reference's sum;
  * meta tensors take the card's decode scores, the CPU the upcast
    form bit for bit; the sharded loss's backward keeps its gradient on
    each rank's shard;
  * no placeholder group outlives a cell; a default group, or a missing
    placeholder backend, is refused;
  * `iter_cells` the reference's sequence, skips and reasons included;
  * the record's keys the reference's; the CLI's exit codes.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
import torch.utils._pytree as _pytree

from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun as port_dryrun
from repro_torch.launch import specs as port_sp
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import registry as port_registry
from repro_torch.optim import adamw, cosine_lr
from repro_torch.runtime import sharding as sh

REPO = pathlib.Path(__file__).resolve().parents[1]

#: (arch, shape, multi_pod): the cells compiled on both sides
CELLS = [
    ("musicgen-medium", "train_4k", False),
    ("musicgen-medium", "train_4k", True),
    ("musicgen-medium", "prefill_32k", True),
    ("zamba2-2.7b", "decode_32k", True),
]
#: iter_cells' arguments compared
ITER_ARGS = [(False, None, None), (True, None, None),
             (False, "llama3-8b", None), (False, None, "long_500k")]

_REFERENCE_SCRIPT = """
import json, sys
import repro.launch.dryrun as dr  # sets 512 placeholder devices first
import jax
assert jax.device_count() == 512, jax.device_count()
from repro.models import registry

cells, iter_args = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {"records": [], "iter": []}
for arch, shape, mp in cells:
    rec = dr.dryrun_cell(arch, registry.get_shapes(arch)[shape], mp,
                         save=False, verbose=False)
    out["records"].append(rec)
for args in iter_args:
    out["iter"].append([[a, c.name, c.seq_len, c.global_batch, c.kind,
                         c.skip, mp] for a, c, mp in dr.iter_cells(*args)])
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = f"{REPO / 'src'}:{REPO}"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE_SCRIPT),
         json.dumps(CELLS), json.dumps(ITER_ARGS)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def cell_records():
    """The port's records of CELLS."""
    return [port_dryrun.dryrun_cell(
        arch, port_registry.get_shapes(arch)[shape], mp, save=False,
        verbose=False) for arch, shape, mp in CELLS]


@pytest.mark.parametrize("index", range(len(CELLS)),
                         ids=[f"{a}-{s}-{'pod2x16x16' if m else 'pod16x16'}"
                              for a, s, m in CELLS])
def test_argument_bytes_equal_the_references(reference, cell_records,
                                             index):
    arch, shape, mp = CELLS[index]
    ref = reference["records"][index]
    ours = cell_records[index]
    assert (ours["arch"], ours["shape"], ours["mesh"]) == (
        ref["arch"], ref["shape"], ref["mesh"])
    assert ours["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
    assert ours["devices"] == ref["devices"]
    # the keys are the reference's and the port's own count of the ops
    # torch 2.11's DTensor refuses (none); the port counts its
    # temporaries, has no generated code to report, and says so
    assert set(ours) == set(ref) | {"sharding_refusals"}
    assert ours["sharding_refusals"] == 0
    assert set(ours["memory"]) == set(ref["memory"])
    mem = ours["memory"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["generated_code_size_in_bytes"] is None
    assert ours["bytes_per_device"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + max(mem["output_size_in_bytes"] - mem["alias_size_in_bytes"], 0))
    counts = ours["hlo_collective_op_counts"]
    assert tuple(counts) == port_dryrun.KINDS == tuple(
        ref["hlo_collective_op_counts"])
    assert {k for k, n in counts.items() if n} == set(
        ours["collectives"]) - {"pod_mix"}
    assert ours["cost"]["flops"] > 0
    kinds = set(ours["collectives"]) - {"pod_mix"}
    assert kinds and kinds <= set(port_dryrun.KINDS)
    assert set(ref["collectives"]) <= set(port_dryrun.KINDS)
    assert all(v > 0 for v in ours["collectives"].values())
    # the pod mix: one all-reduce of each device's float32 parameter shard
    # on the complete graph of two pods, in the training cells on two pods
    assert ("pod_mix" in ours["collectives"]) == (shape == "train_4k"
                                                  and mp)
    assert not dist.is_initialized()  # the placeholder group is gone


#: the port's bytes of CELLS before its products ran on local shards
#: (PERF.md's table of these cells), printed beside today's
BEFORE_LOCAL_PRODUCTS = [
    {"all-gather": 90407972864, "all-reduce": 5184233504,
     "reduce-scatter": 350741248, "all-to-all": 3624402944},
    {"all-gather": 50981515264, "all-reduce": 5083570208,
     "reduce-scatter": 344441600, "all-to-all": 1812201472,
     "pod_mix": 21369216},
    {"all-gather": 17485338624, "all-reduce": 100663296,
     "all-to-all": 603979776},
    {"all-gather": 66845184, "all-reduce": 31908560,
     "reduce-scatter": 1989520, "all-to-all": 3174400},
]


def test_print_collectives_beside_xlas(reference, cell_records, capsys):
    """Each compared cell's bytes a device by kind beside XLA's and the
    port's before its products ran on local shards: printed, no
    tolerance (DTensor and GSPMD choose otherwise)."""
    with capsys.disabled():
        for (arch, shape, mp), ours, ref, old in zip(
                CELLS, cell_records, reference["records"],
                BEFORE_LOCAL_PRODUCTS):
            print(f"\n[collectives] {arch} {shape} "
                  f"{'pod2x16x16' if mp else 'pod16x16'}")
            for kind in port_dryrun.KINDS + ("pod_mix",):
                print(f"  {kind:18s} port {ours['collectives'].get(kind)}"
                      f"  xla {ref['collectives'].get(kind)}"
                      f"  port before {old.get(kind)}")
    assert len(cell_records) == len(reference["records"])


#: the compared train and prefill cells' temporaries (the first three of
#: CELLS) may exceed XLA's by this factor (PERF.md: 1.05-1.11 observed);
#: zamba2's decode cell is printed only (the port holds a thousandth of
#: XLA's there)
TEMP_OVER_XLA = 1.25


def test_temporaries_within_a_quarter_of_xlas(reference, cell_records,
                                              capsys):
    """Each compared cell's temporaries, bytes a device and collective
    calls by kind beside XLA's, printed; the train and prefill cells'
    temporaries held to at most TEMP_OVER_XLA times XLA's (XLA assigns
    buffers and rematerializes where eager torch frees as it goes, and
    its HLO holds a loop body's collectives once: the calls are printed,
    not held)."""
    with capsys.disabled():
        for (arch, shape, mp), ours, ref in zip(CELLS, cell_records,
                                                reference["records"]):
            print(f"\n[memory] {arch} {shape} "
                  f"{'pod2x16x16' if mp else 'pod16x16'}: temp port "
                  f"{ours['memory']['temp_size_in_bytes']} xla "
                  f"{ref['memory']['temp_size_in_bytes']}; bytes_per_device "
                  f"port {ours['bytes_per_device']} xla "
                  f"{ref['bytes_per_device']}")
            for kind in port_dryrun.KINDS:
                print(f"  {kind:18s} calls port "
                      f"{ours['hlo_collective_op_counts'][kind]}  xla "
                      f"{ref['hlo_collective_op_counts'][kind]}")
    assert len(cell_records) == len(reference["records"])
    over = {f"{arch} {shape} {mp}": ours["memory"]["temp_size_in_bytes"]
            / ref["memory"]["temp_size_in_bytes"]
            for (arch, shape, mp), ours, ref in zip(
                CELLS, cell_records, reference["records"])
            if shape != "decode_32k"}
    assert len(over) == 3
    assert max(over.values()) <= TEMP_OVER_XLA, over


def _layer(x, w):
    return torch.relu(x @ w)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_memory_equals_a_count_by_hand(remat):
    """A two-layer step on meta tensors, each layer relu(h @ w), x (2, 3),
    w1 (3, 5), w2 (5, 7), float32, after one DTensor all-gather of a
    (2, 3) shard over 4 placeholder ranks, whose output W (8, 3) the step
    holds to its end; the gradients of w1 and w2 are returned. In bytes:
    W = 96; the layers' products and outputs m1 = h1 = 40, m2 = h2 = 56;
    the loss L and the backward's seed G0, 4 each; the output gradients
    g2 = 56 and dh1 = 40. The phases are the forward and the backward.
      forward = W + h1 + m2 + h2 = 248 (at relu2: m1 is freed, relu keeps
                its output, not its input)
      backward, plain = W + h1 + h2 + L + G0 + g2 + dh1 = 296 (the second
                layer's input gradient; g2 is freed after it)
      backward, remat = W + h1 + h2 + L + G0 + m2' + h2' = 312 (the second
                layer recomputed beside its checkpointed input h1 and
                the output h2 the step still holds)
    and one all-gather call of 96 bytes."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.checkpoint import checkpoint

    f4 = 4
    W, h1, h2 = 8 * 3 * f4, 2 * 5 * f4, 2 * 7 * f4
    m2, L, G0, g2, dh1 = h2, f4, f4, h2, h1
    want = [W + h1 + m2 + h2,
            W + h1 + h2 + L + G0 + (m2 + h2 if remat else g2 + dh1)]
    assert want == [248, 312 if remat else 296]
    with port_dryrun.placeholder_group(4):
        dm = DeviceMesh("cuda", torch.arange(4), mesh_dim_names=("data",))
        x, w1, w2 = (torch.empty(shape, device="meta")
                     for shape in ((2, 3), (3, 5), (5, 7)))
        shard = DTensor.from_local(torch.empty(2, 3, device="meta"), dm,
                                   [Shard(0)], run_check=False)
        counted = port_dryrun.StepMemory((x, w1, w2, shard))
        with counted:
            whole = shard.redistribute(dm, [Replicate()])
            ws = [w.detach().requires_grad_() for w in (w1, w2)]
            h = x
            for w in ws:
                h = (checkpoint(_layer, h, w, use_reentrant=False) if remat
                     else _layer(h, w))
            grads = torch.autograd.grad(h.sum(), ws)
        assert counted.finish(grads) == max(want)
    assert whole.shape == (8, 3)
    assert counted.phase_peaks == want
    assert counted.calls == {"all-gather": 1}
    assert counted.bytes == {"all-gather": float(W)}


#: the depth the extension is held to, past `DEPTHS`
DIRECT_DEPTH = 4
#: a vocabulary at which llama3-8b smoke's embedding shard is the largest
#: leaf at the `DEPTHS` and a stacked leaf's outgrows it by OVERTAKE_DEPTH
OVERTAKE_VOCAB, OVERTAKE_DEPTH = 1024, 5


def _largest_leaf(cfg, mesh) -> str:
    """The path of the largest local leaf of `cfg`'s parameters on
    `mesh`'s layout."""
    params, specs = port_sp.param_specs(cfg, mesh)
    paths = _pytree.tree_flatten_with_path(params)[0]
    return max(zip(paths, port_sp.spec_leaves(specs)),
               key=lambda ps: port_sp.shard_bytes(ps[0][1], ps[1], mesh)
               )[0][0][0].key


@pytest.mark.parametrize("arch,kind,vocab,depth", [
    ("llama3-8b", "train", None, DIRECT_DEPTH),
    ("llama3-8b", "decode", None, DIRECT_DEPTH),
    ("zamba2-2.7b", "train", None, DIRECT_DEPTH),
    ("zamba2-2.7b", "decode", None, DIRECT_DEPTH),
    ("llama3-8b", "train", OVERTAKE_VOCAB, OVERTAKE_DEPTH),
], ids=["llama3-8b-train", "llama3-8b-decode", "zamba2-2.7b-train",
        "zamba2-2.7b-decode", "overtake-train"])
def test_extension_equals_a_direct_count(arch, kind, vocab, depth):
    """The counts at `DEPTHS` superblocks extended to `depth`
    (`dryrun._meta_runs`: the peak phase by phase, a train step's tail
    counted alone there) equal a count at `depth` exactly: a dense and the
    hybrid smoke arch (its shared attention's weights in every
    superblock), a training step and a decode step, on a placeholder
    (data 2, model 2) layout; and a train step whose largest leaf is the
    embedding's shard at the `DEPTHS` and a stacked one at `depth`, where
    the tail's peak grows by more than its slope between the `DEPTHS`
    (extended from them as the other phases are, it falls short)."""
    from torch.distributed.device_mesh import DeviceMesh

    assert depth > max(port_dryrun.DEPTHS)
    cfg = dataclasses.replace(port_registry.get_config(arch, "smoke"),
                              train_microbatches=1,
                              vocab_size=vocab or port_registry.get_config(
                                  arch, "smoke").vocab_size)
    cell = ShapeCell(kind, 16, 4, kind)
    optimizer = adamw(cosine_lr(3e-4, 10))
    with port_dryrun.placeholder_group(4) as group:
        dm = DeviceMesh("cuda", torch.arange(4).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
        mesh = Mesh(("data", "model"), (2, 2), torch.device("meta"), group,
                    dm)
        deep = dataclasses.replace(cfg, n_super=depth)
        ext = port_dryrun._meta_runs(deep, cell, mesh, False, optimizer)
        direct = port_dryrun.count_step(deep, cell, mesh, optimizer,
                                        memory=True)
        if vocab:
            assert [_largest_leaf(dataclasses.replace(cfg, n_super=n), mesh)
                    for n in port_dryrun.DEPTHS + (depth,)] == [
                        "embed", "embed", "stack"]
    if kind == "train":  # forward, backward, the gradients' stacking, the
        # tail
        assert len(direct.phase_peaks) == 4 and direct.tail == 3
    else:
        assert len(direct.phase_peaks) == 1 and direct.tail is None
    assert ext["temp"] == direct.temp > 0
    assert ext["calls"] == direct.calls
    assert ext["collectives"] == direct.bytes
    assert ext["refused"] == len(direct.refused) == 0


def test_meta_takes_the_cards_decode_scores():
    """`attention._bmm_f32` on meta bf16 operands takes the card's form (a
    bf16 product with float32 output, no float32 copy of either operand),
    and on the CPU the upcast form, as before, bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.attention import _bmm_f32

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    a = torch.empty(2, 3, 4, dtype=torch.bfloat16, device="meta")
    b = torch.empty(2, 4, 5, dtype=torch.bfloat16, device="meta")
    with Ops() as ops:
        out = _bmm_f32(a, b)
    assert (out.dtype, out.shape) == (torch.float32, (2, 3, 5))
    assert ops.names == ["aten.bmm.dtype"]
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(shape, generator=gen).to(torch.bfloat16)
            for shape in ((2, 3, 4), (2, 4, 5)))
    assert torch.equal(_bmm_f32(a, b), torch.bmm(a.float(), b.float()))


def test_sharded_loss_keeps_its_gradient_sharded():
    """The loss's gold logits on DTensor logits (rows over 'data' 2, vocab
    over 'model' 4) take a rank's own shard, forward and backward: the
    backward's temporaries stay below the whole float32 logits, which
    DTensor's own gather made in its backward on every rank (zeros of the
    global shape, replicated). (The log-sum-exp runs on the shards too:
    tests/test_torch_attention_memory.py.)"""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.common import cross_entropy_loss

    B, S, V = 4, 8, 64
    with port_dryrun.placeholder_group(8):
        dm = DeviceMesh("cuda", torch.arange(8).reshape(2, 4),
                        mesh_dim_names=("data", "model"))
        logits = DTensor.from_local(
            torch.empty(B // 2, S, V // 4, device="meta"), dm,
            [Shard(0), Shard(2)], run_check=False, shape=(B, S, V),
            stride=(S * V, V, 1)).requires_grad_()
        labels = DTensor.from_local(
            torch.empty(B // 2, S, dtype=torch.int32, device="meta"), dm,
            [Shard(0), Replicate()], run_check=False, shape=(B, S),
            stride=(S, 1))
        counted = port_dryrun.StepMemory((logits, labels))
        with counted:
            grad, = torch.autograd.grad(
                cross_entropy_loss(logits, labels), logits)
        counted.finish(grad)
        assert tuple(grad.placements) == (Shard(0), Shard(2))
    forward, backward = counted.phase_peaks
    assert 0 < backward < B * S * V * 4


#: the small case: llama3-8b smoke, 8 rows of 32 tokens, two microbatches,
#: on a placeholder (data 2, model 2) layout
SMALL = dict(arch="llama3-8b", rows=8, seq=32, microbatches=2)
#: the leaves the sharded step gathers over 'model' too, in the one
#: redistribute that gathers them over 'data' (`runtime.sharding.project`
#: on sequence-parallel tokens): the FFN's in every layer
GATHERED_OVER_MODEL = ("w_up", "w_gate", "w_down")
#: q's, k's and v's: in every layer but the first, whose input (the
#: embedding's) lies whole over 'model', so that its projections keep
#: their heads there
GATHERED_OVER_MODEL_AFTER_THE_FIRST = ("wq", "wk", "wv")


def test_small_case_equals_its_hand_count():
    """The collectives over 'data' of a training step on (data D=2, model
    m=2) at M microbatches of B/M rows of S tokens, from the placements
    alone. For each layer's share of a leaf l sharded over 'data' (FSDP),
    with `local` its shard's bytes, `uses` 2 in the layer stack (the
    forward and the backward's recompute) and 1 outside it, and f = m
    where the share is gathered over 'model' too, else 1:
      all-gather     = M sum_l uses D f local  (no token id and no row of
                         the batch: the embedding looks up and scatters
                         its gradient on each rank's own rows; a share
                         gathered over both axes in one redistribute is
                         gathered over 'model' first, so its gather over
                         'data' outputs the whole leaf)
      reduce-scatter = M sum_l f local       (every gradient back in one
                         redistribute: a partial sum over 'data' (the
                         table's of each rank's rows included), or over
                         both axes, reduce-scattered over 'data' first,
                         on the whole gradient, then over 'model'; no
                         all-reduce over 'data' whole any more)
      all-reduce     = 4 (2 M + 1)           (float32 scalars: each
                         microbatch's loss sum and token count, the grad
                         norm)
      all-to-all     = 2 (B / D) S 4         (tokens and labels, int32,
                         to their microbatches' ranks)
    The implementation meets each identity exactly."""
    from torch.distributed.device_mesh import DeviceMesh

    M, D, m = SMALL["microbatches"], 2, 2
    B, S = SMALL["rows"], SMALL["seq"]
    cfg = dataclasses.replace(port_registry.get_config(SMALL["arch"],
                                                       "smoke"),
                              train_microbatches=M)
    with port_dryrun.placeholder_group(D * m) as group:
        dm = DeviceMesh("cuda", torch.arange(D * m).reshape(D, m),
                        mesh_dim_names=("data", "model"))
        mesh = Mesh(("data", "model"), (D, m), torch.device("meta"), group,
                    dm)
        counted = port_dryrun.count_step(cfg, ShapeCell("small", S, B,
                                                        "train"),
                                         mesh, adamw(cosine_lr(3e-4, 10)))
        data = tuple(dist.get_process_group_ranks(
            dm.get_group(0)))
    got = {k: b for (k, g), b in counted.by_group.items() if g == data}
    params, axes = port_sp.params_and_axes(cfg)
    want = {"all-gather": 0, "reduce-scatter": 0,
            "all-reduce": 4 * (2 * M + 1), "all-to-all": 2 * (B // D) * S * 4}
    for (path, t), a in zip(_pytree.tree_flatten_with_path(params)[0],
                            _pytree.tree_leaves(axes,
                                                is_leaf=sh.is_axes_leaf)):
        spec = sh.logical_to_spec(t.shape, a, sh.DEFAULT_RULES,
                                  {"data": D, "model": m})
        if "data" not in spec:
            continue
        local = t.numel() * t.element_size() // D // (
            m if "model" in spec else 1)
        stacked = path[0].key == "stack"
        uses, layers = (2, t.shape[0]) if stacked else (1, 1)
        name = path[-1].key
        for j in range(layers):
            f = m if (name in GATHERED_OVER_MODEL or (
                j > 0 and name in GATHERED_OVER_MODEL_AFTER_THE_FIRST)) else 1
            want["all-gather"] += M * uses * D * f * local // layers
            want["reduce-scatter"] += M * f * local // layers
    assert got == want


def test_dryrun_leaves_no_group_and_refuses_one(monkeypatch):
    cell = port_registry.get_shapes("zamba2-2.7b")["decode_32k"]
    port_dryrun.dryrun_cell("zamba2-2.7b", cell, False, save=False,
                            verbose=False)
    assert not dist.is_initialized()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="default process group "
                                               "exists"):
            port_dryrun.dryrun_cell("zamba2-2.7b", cell, False, save=False,
                                    verbose=False)
    finally:
        dist.destroy_process_group()
    # without the placeholder backend the count is refused, not skipped
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="placeholder process group"):
        port_dryrun.dryrun_cell("zamba2-2.7b", cell, False, save=False,
                                verbose=False)
    assert not dist.is_initialized()


def _tree_bytes(tree, specs, mesh) -> int:
    return sum(port_sp.shard_bytes(t, s, mesh) for t, s in
               zip(torch.utils._pytree.tree_leaves(tree),
                   port_sp.spec_leaves(specs)))


def test_prefill_leaves_its_unread_labels_out(reference):
    """All of the prefill cell's arguments less its `labels` are the bytes
    the reference's compiled step takes."""
    mesh = make_production_mesh(multi_pod=True)
    cfg = port_registry.get_config("musicgen-medium", "full")
    cell = port_registry.get_shapes("musicgen-medium")["prefill_32k"]
    params, pspecs = port_sp.param_specs(cfg, mesh)
    batch, bspecs = port_sp.batch_specs(cfg, cell, mesh, consensus=False)
    every = (_tree_bytes(params, pspecs, mesh)
             + _tree_bytes(batch, bspecs, mesh))
    labels = port_sp.shard_bytes(batch["labels"], bspecs["labels"], mesh)
    assert (every, labels) == (10965376, 32 * 32768 * 4 // 32)
    assert every - labels == \
        reference["records"][2]["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("index", range(len(ITER_ARGS)))
def test_iter_cells_is_the_references(reference, index):
    ours = [[a, c.name, c.seq_len, c.global_batch, c.kind, c.skip, mp]
            for a, c, mp in port_dryrun.iter_cells(*ITER_ARGS[index])]
    assert ours == reference["iter"][index]


def test_cli_exit_codes_and_saved_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(port_dryrun, "RESULTS", tmp_path)
    assert port_dryrun.main(["--arch", "musicgen-medium", "--shape",
                             "decode_32k", "--single-pod-only"]) == 0
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert saved == ["musicgen-medium__decode_32k__pod16x16.json"]
    rec = json.loads((tmp_path / saved[0]).read_text())
    assert rec["memory"]["argument_size_in_bytes"] == 4842541476.0
    assert port_dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k",
                             "--no-save"]) == 0
    assert "SKIP llama3-8b long_500k" in capsys.readouterr().out

    def broken(*args, **kwargs):
        raise RuntimeError("cell failed")
    monkeypatch.setattr(port_dryrun, "dryrun_cell", broken)
    assert port_dryrun.main(["--arch", "musicgen-medium", "--shape",
                             "decode_32k", "--no-save"]) == 1
    assert "FAILURES" in capsys.readouterr().out


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "zamba2-2.7b", "--shape", "decode_32k", "--multi-pod-only",
         "--no-save"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "zamba2-2.7b decode_32k pod2x16x16" in out.stdout
    assert "all requested cells built OK" in out.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--bogus"],
        capture_output=True, text=True, env=env, timeout=300)
    assert bad.returncode == 2
