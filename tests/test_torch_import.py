"""The port stands alone: `repro_torch` imports neither jax nor `repro`, and
its entry points run on the CUDA card unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.experiments import __main__ as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
MANIFEST = ROOT / "benchmarks" / "manifests" / "expander_periodic.json"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.experiments, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.compress, repro_torch.kernels.compress_mix\n"
        "import repro_torch.experiments.__main__\n"
        "import repro_torch.netsim, repro_torch.adaptive, repro_torch.faults\n"
        "import repro_torch.checkpoint, repro_torch.runtime\n"
        "import repro_torch.runtime.elastic, repro_torch.core.compression\n"
        "import repro_torch.core.consensus_sgd, repro_torch.launch.train\n"
        "import repro_torch.models.mlp, repro_torch.models.attention\n"
        "import repro_torch.serve, repro_torch.serve.__main__\n"
        "from repro_torch.serve import ExperimentServer, Client, WorkerPool\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_spawned_toy_worker_loads_no_torch():
    """A pool worker's spawn imports the module of its target alone:
    `repro_torch.serve.pool` (and the lazy package above it) must load
    neither torch nor jax, so toy workers start in milliseconds."""
    code = (
        "import sys\n"
        "from repro_torch.serve.pool import _toy_worker_main\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'numpy', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_port_file_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    spec = repro_torch.ExperimentSpec.from_file(MANIFEST)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.run(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.run_all(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", str(MANIFEST), "--backend", "dense"])


def test_simulator_default_device_raises_without_a_card(no_card):
    from repro_torch.core.dda import DDASimulator
    from repro_torch.core.graphs import complete_graph

    with pytest.raises(RuntimeError, match="CUDA"):
        DDASimulator(lambda x, t, k: x, lambda x: x.sum(), complete_graph(4))


def test_explicit_cpu_is_honored(no_card):
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    assert repro_torch.resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        repro_torch.resolve_device("meta")
    result = repro_torch.run(repro_torch.ExperimentSpec.from_file(MANIFEST),
                             "dense", device="cpu")
    assert result.extras == {"mix_mode": "sparse"}
