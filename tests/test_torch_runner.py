"""`repro_torch.run(spec, device="cpu")` against `repro.run(spec)` on the
dense backend of every dense manifest, compressed and uncompressed, under
the port's parity check (`convert.assert_results_match`: host fields exact,
trace floats and residual norms rtol 1e-5, atol 1e-6), plus the CLI, the
refusal of what is not ported yet (the launch backend's families other
than the dense one) and the paths that were refused before (netsim
manifests, the dense closed loop)."""

import copy
import os
import pathlib
import subprocess
import sys

import pytest

import repro

import repro_torch
from repro_torch.convert import ATOL, RTOL, assert_results_match
from repro_torch.experiments import __main__ as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
MANIFESTS = ROOT / "benchmarks" / "manifests"
DENSE = ["complete_every", "expander_periodic", "expander_sparse",
         "fig1_complete", "fig1_reduced", "fig2_sparse"]


def _port(name, **kw):
    spec = repro_torch.ExperimentSpec.from_file(MANIFESTS / f"{name}.json")
    return repro_torch.run(spec, "dense", device="cpu", **kw)


@pytest.mark.parametrize("name", DENSE)
def test_dense_manifest_matches_reference(name):
    ours = _port(name).to_dict()
    theirs = repro.run(repro.ExperimentSpec.from_file(
        MANIFESTS / f"{name}.json"), "dense").to_dict()
    assert_results_match(ours, theirs)
    assert ours["extras"]["mix_mode"] == (
        "sparse" if name.startswith("expander") else "dense")


def test_parity_check_catches_differences():
    base = _port("expander_sparse").to_dict()
    assert_results_match(base, copy.deepcopy(base))
    near = copy.deepcopy(base)
    near["trace"]["fvals"] = [v * (1 + RTOL / 4) for v in near["trace"]["fvals"]]
    near["wall_s"] += 5.0
    near["metrics"]["execute_s"] += 5.0
    assert_results_match(near, base)
    diverged = copy.deepcopy(base)
    diverged["trace"]["fvals"][-1] = None  # a sanitized inf/nan
    assert_results_match(diverged, copy.deepcopy(diverged))
    with pytest.raises(AssertionError, match="fvals"):
        assert_results_match(diverged, base)
    for field, edit in [
            ("fvals", lambda d: d["trace"]["fvals"].__setitem__(
                -1, d["trace"]["fvals"][-1] * (1 + 10 * RTOL) + 10 * ATOL)),
            ("iters", lambda d: d["trace"]["iters"].__setitem__(0, 16)),
            ("time_to_target", lambda d: d.__setitem__(
                "time_to_target", d["time_to_target"] + 0.1)),
            ("predictions", lambda d: d["predictions"].__setitem__(
                "h_opt", d["predictions"]["h_opt"] + 1)),
            ("msgs", lambda d: d["metrics"].__setitem__(
                "msgs", d["metrics"]["msgs"] + 1))]:
        bad = copy.deepcopy(base)
        edit(bad)
        with pytest.raises(AssertionError, match=field):
            assert_results_match(bad, base)


def test_cli_run_writes_a_result_that_loads_back(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    manifest = MANIFESTS / "expander_periodic.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", "run",
         str(manifest), "--backend", "dense", "--device", "cpu",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = tmp_path / "expander_periodic__dense.json"
    loaded = repro_torch.RunResult.from_json(path.read_text())
    assert_results_match(loaded.to_dict(), _port("expander_periodic").to_dict())
    assert (tmp_path / "expander_periodic__dense.trace.json").exists()
    assert cli.main(["trace", str(path)]) == 0


def test_cli_list_names_the_registries(capsys):
    assert cli.main(["list"]) == 0
    out = capsys.readouterr().out
    assert "backend kinds: dense, launch, netsim" in out
    assert "problem kinds: least_squares, lm, metric_learning" in out


def test_run_all_on_a_dense_only_manifest():
    spec = repro_torch.ExperimentSpec.from_file(MANIFESTS / "fig2_sparse.json")
    results = repro_torch.run_all(spec, device="cpu")
    assert [r.backend.kind for r in results] == ["dense"]


def _reference(name, backend="dense"):
    return repro.run(repro.ExperimentSpec.from_file(
        MANIFESTS / f"{name}.json"), backend).to_dict()


def test_compressed_manifest_matches_reference():
    """compressed_expander (top-k keep 1/8, sparse mix through K2's plain
    version), the compression block included."""
    ours = _port("compressed_expander").to_dict()
    theirs = _reference("compressed_expander")
    assert_results_match(ours, theirs)
    block = ours["extras"]["compression"]
    assert ours["extras"]["mix_mode"] == "sparse"
    assert block == ours["metrics"]["compression"]
    assert block["kind"] == "topk" and block["wire_ratio"] == 0.25
    assert block["bytes_saved"] == 0.75 * 149 * 16 * 4 * 64 * 4
    assert len(block["residual_norms"]) == len(ours["trace"]["iters"])
    assert ours["predictions"]["wire_ratio"] == 0.25
    assert ours["metrics"]["bytes_on_wire"] == 0.25 * 149 * 16 * 4 * 64 * 4


def test_compress_keep_param_matches_reference():
    spec = repro_torch.ExperimentSpec.from_file(MANIFESTS /
                                                "expander_periodic.json")
    backend = repro_torch.ComponentSpec("dense", {"compress_keep": 0.25})
    ours = repro_torch.run(spec, backend, device="cpu").to_dict()
    theirs = repro.run(repro.ExperimentSpec.from_file(
        MANIFESTS / "expander_periodic.json"),
        repro.ComponentSpec("dense", {"compress_keep": 0.25})).to_dict()
    assert_results_match(ours, theirs)
    assert ours["extras"]["compression"]["kind"] == "topk"
    both = repro_torch.ExperimentSpec.from_file(
        MANIFESTS / "compressed_expander.json")
    with pytest.raises(ValueError, match="mutually exclusive"):
        repro_torch.run(both, backend, device="cpu")


def test_parity_check_compares_the_compression_block():
    base = _port("compressed_expander").to_dict()
    near = copy.deepcopy(base)
    for block in (near["extras"]["compression"],
                  near["metrics"]["compression"]):
        block["residual_norms"] = [v * (1 + RTOL / 4)
                                   for v in block["residual_norms"]]
    assert_results_match(near, base)
    for where, field, edit in [
            ("extras", "residual_norms", lambda b: b["residual_norms"]
             .__setitem__(-1, b["residual_norms"][-1] * (1 + 10 * RTOL))),
            ("metrics", "residual_norms", lambda b: b["residual_norms"]
             .pop()),
            ("extras", "bytes_saved", lambda b: b.__setitem__(
                "bytes_saved", b["bytes_saved"] + 1.0)),
            ("metrics", "kind", lambda b: b.__setitem__("kind", "randk")),
            ("extras", "wire_ratio", lambda b: b.__setitem__(
                "wire_ratio", 0.5))]:
        bad = copy.deepcopy(base)
        edit(bad[where]["compression"])
        with pytest.raises(AssertionError, match=f"{where}.compression"):
            assert_results_match(bad, base)
    missing = copy.deepcopy(base)
    del missing["extras"]["compression"]
    with pytest.raises(AssertionError, match="extras.compression"):
        assert_results_match(missing, base)
    other = copy.deepcopy(base)
    other["extras"]["mix_mode"] = "dense"
    with pytest.raises(AssertionError, match="extras"):
        assert_results_match(other, base)


@pytest.mark.parametrize("name,backend", [
    ("launch_dryrun", "launch"),
])
def test_unported_paths_raise(name, backend):
    """The launch backend runs the attention families ("attn", "attn_moe",
    "mla", "mla_moe"); the manifest's spec for a family with a kind still
    unported (zamba2's Mamba-2 blocks) raises, naming the block kind."""
    d = repro_torch.ExperimentSpec.from_file(
        MANIFESTS / f"{name}.json").to_dict()
    d["problem"]["params"]["arch"] = "zamba2-2.7b"
    spec = repro_torch.ExperimentSpec.from_dict(d)
    with pytest.raises(NotImplementedError,
                       match="'mamba2' is not ported yet"):
        repro_torch.run(spec, backend, device="cpu")


@pytest.mark.parametrize("name,backend", [
    ("expander_periodic", "netsim"),
    ("churn_adversarial", "netsim"),
    ("adaptive_adversarial", "dense"),
])
def test_formerly_refused_paths_match_reference(name, backend):
    """The paths the port refused before the netsim backend and the dense
    closed loop: each now gives the reference's result, or its error."""
    path = MANIFESTS / f"{name}.json"
    spec = repro_torch.ExperimentSpec.from_file(path)
    ref_spec = repro.ExperimentSpec.from_file(path)
    try:
        theirs = repro.run(ref_spec, backend)
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            repro_torch.run(spec, backend, device="cpu")
        assert str(ours.value) == str(err)
        return
    ours = repro_torch.run(spec, backend, device="cpu").to_dict()
    assert ours["trace"] == theirs.to_dict()["trace"]
    assert_results_match(ours, theirs.to_dict())
