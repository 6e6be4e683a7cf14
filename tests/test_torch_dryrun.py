"""The port's production dry-run (`repro_torch.launch.dryrun`) against the
JAX package's, on the CPU.

The reference lowers and compiles a cell for 512 placeholder devices (in a
subprocess: its module sets the device count before jax starts) and
reads XLA's `memory_analysis()`; the port reckons the same arguments'
per-device bytes from its specs on the meta device. Standards:
  * `argument_size_in_bytes` equal exactly, on the four cells below (the
    prefill cell's `labels`, which its step never reads, left out on both
    sides);
  * `iter_cells` the reference's sequence, skips and reasons included;
  * the record's keys the reference's; the CLI's exit codes.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import dryrun as port_dryrun
from repro_torch.launch import specs as port_sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry as port_registry

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


@pytest.mark.parametrize("index", range(len(CELLS)),
                         ids=[f"{a}-{s}-{'pod2x16x16' if m else 'pod16x16'}"
                              for a, s, m in CELLS])
def test_argument_bytes_equal_the_references(reference, index):
    arch, shape, mp = CELLS[index]
    ref = reference["records"][index]
    ours = port_dryrun.dryrun_cell(
        arch, port_registry.get_shapes(arch)[shape], mp, save=False,
        verbose=False)
    assert (ours["arch"], ours["shape"], ours["mesh"]) == (
        ref["arch"], ref["shape"], ref["mesh"])
    assert ours["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
    assert ours["devices"] == ref["devices"]
    # the keys are the reference's; the port has no temporaries or code
    # size to report, and says so
    assert set(ours) == set(ref)
    assert set(ours["memory"]) == set(ref["memory"])
    assert ours["memory"]["temp_size_in_bytes"] is None
    assert ours["memory"]["generated_code_size_in_bytes"] is None
    assert ours["cost"]["flops"] > 0
    if shape == "train_4k" and mp:
        # the pod mix: one all-reduce of each device's float32 parameter
        # shard on the complete graph of two pods
        assert ours["collectives"]["pod_mix"] > 0
    else:
        assert ours["collectives"] == {}


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
