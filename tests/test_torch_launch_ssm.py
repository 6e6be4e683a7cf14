"""The launch backend on the state-space families against the JAX package's,
on the CPU: falcon-mamba-7b (Mamba-1) and zamba2-2.7b (Mamba-2 with its
weight-shared attention, FFN and per-repetition LoRA) trained at smoke
width through `repro_torch.run` at mesh (2, 1, 1), each against
`repro.run` of the same spec in a subprocess with two host devices, as
`tests/test_torch_launch.py` runs llama3's (the float32 parity of the
pieces and of both whole models is `tests/test_torch_ssm.py`'s); and the
leaves the pod mix takes a comm step, at smoke and full width.

Each side draws its own parameters from the seed (bit for bit at these
widths but one bf16 element of an `in_proj`, tests/test_torch_ssm.py).

Standards (ROADMAP queue 3 gives the observed errors):
  * the host fields and extras (iters, sim_time, comms, comm_rounds,
    sim_time_units, msgs, bytes_on_wire, gossip_rounds, param_bytes,
    step_comm): exact;
  * the bf16 loss trace: rtol 5e-4, the dense family's (observed 5.4e-5
    for falcon-mamba and 2.1e-4 for zamba2).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.compress import prng
from repro_torch.convert import assert_results_match
from repro_torch.models import registry as port_registry
from repro_torch.models import transformer as port_tf

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
TRACE_RTOL = 5e-4
BATCH, SEQ = 2, 32


def _spec(arch: str) -> dict:
    return {
        "name": "lm_ssm_mesh2",
        "problem": {"kind": "lm", "params": {"arch": arch,
                                             "variant": "smoke",
                                             "batch_per_node": BATCH,
                                             "seq_len": SEQ}},
        "topology": {"kind": "complete", "params": {}},
        "schedule": {"kind": "periodic", "params": {"h": 2}},
        "backends": [{"kind": "launch", "params": {"mesh": [2, 1, 1]}}],
        "T": 6, "eval_every": 1, "seed": 0, "r": 0.05,
    }


_REFERENCE_SCRIPT = """
import json, sys
import repro

out = {spec["problem"]["params"]["arch"]:
       repro.run(repro.ExperimentSpec.from_dict(spec)).to_dict()
       for spec in json.loads(sys.argv[1])}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_results():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = f"{REPO / 'src'}:{REPO}"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE_SCRIPT),
         json.dumps([_spec(a) for a in ARCHS])],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("arch", ARCHS)
def test_run_at_mesh_2_matches_reference(arch, reference_results):
    ours = repro_torch.run(repro_torch.ExperimentSpec.from_dict(_spec(arch)),
                           "launch", device=CPU).to_dict()
    ref = reference_results[arch]
    for key in ("fvals", "fvals_consensus"):
        np.testing.assert_allclose(ours["trace"][key], ref["trace"][key],
                                   rtol=TRACE_RTOL)
        ours["trace"][key] = ref["trace"][key]
    # host fields and extras exact, timings present
    assert_results_match(ours, ref)
    assert ours["extras"]["step_comm"] == [False, False, True, False,
                                           True, False]
    assert ours["metrics"]["msgs"] == 2 * 2 * 1
    assert all(np.isfinite(ours["trace"]["fvals"]))


@pytest.mark.parametrize("arch,variant,leaves", [
    ("falcon-mamba-7b", "smoke", 13), ("zamba2-2.7b", "smoke", 33),
    ("falcon-mamba-7b", "full", 13), ("zamba2-2.7b", "full", 60)])
def test_pod_mix_leaf_counts(arch, variant, leaves):
    """One K1 launch a leaf a comm step: falcon-mamba's 10 Mamba-1 leaves
    (stacked over its layers) and embed, lm_head and final_norm; zamba2's
    9 leaves a Mamba-2 slot, the 4 LoRA leaves, the shared attention's 5
    and the shared FFN's 3, and the same three (at full width five Mamba-2
    slots). The full configs' block structure at narrow widths."""
    cfg = port_registry.get_config(arch, variant)
    if variant == "full":
        cfg = dataclasses.replace(
            cfg, n_super=1, d_model=32, vocab_size=64, num_heads=2,
            num_kv_heads=2, head_dim=8, d_ff=16 if cfg.d_ff else 0,
            ssm_state=4, ssm_head_dim=8, shared_attn_lora=4)
    params, _ = port_tf.init(prng.key(0), cfg)
    assert len(torch.utils._pytree.tree_leaves(params)) == leaves
