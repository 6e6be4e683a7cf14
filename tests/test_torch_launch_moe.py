"""The launch backend on the MoE and MLA families against the JAX package's,
on the CPU: deepseek-v2 (MLA prologue, MLA + MoE superblock, top-2 with a
shared expert) and llama4-maverick (GQA + dense FFN, GQA + MoE, top-1)
trained at smoke width through `repro_torch.run` at mesh (2, 1, 1), each
against `repro.run` of the same spec in a subprocess with two host
devices, as `tests/test_torch_launch.py` runs llama3's; and deepseek-v2
through `launch.train.train_consensus_lm` with SGD without momentum, the
entry point of the full-width card cell (`chip_smoke.py` `lm_moe_full`).

Each side draws its own parameters from the seed. The bf16 leaves are the
reference's bits; the float32 router is not quite (XLA's `log1p` residue,
ROADMAP queue 3): its differing elements are counted, and so are the
router choices of each pod's first forward that differ between the two
packages (each on its own parameters and the pod's first batch).

Standards (ROADMAP queue 3 gives the observed errors):
  * the host fields and extras (iters, sim_time, comms, comm_rounds,
    sim_time_units, msgs, bytes_on_wire, gossip_rounds, param_bytes,
    step_comm): exact;
  * the bf16 loss trace: rtol 5e-3. Observed 2.5e-3 (deepseek-v2; 2.6e-3
    under SGD) and 1.8e-3 (maverick), against the dense family's 1.4e-4:
    bf16 roundings of the activations flip router choices near ties;
  * the router residue: at most 3 ulps, on under 2% of the elements
    (observed 35 and 36 of 4,096, both pods, 3 ulps); the first forward's
    flipped choices under 5% of each layer's (observed deepseek-v2 2, 2,
    0, 1 of 128 a layer and pod; maverick 0 of 64).
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf

import repro_torch
from repro_torch import optim as port_optim
from repro_torch.compress import prng
from repro_torch.convert import assert_results_match
from repro_torch.core.schedules import Periodic
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train_consensus_lm
from repro_torch.models import registry as port_registry
from repro_torch.models import transformer as port_tf

from _moe_routing import record_port_choices, record_reference_choices

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
TRACE_RTOL = 5e-3
BATCH, SEQ = 2, 32


def _spec(arch: str) -> dict:
    return {
        "name": "lm_moe_mesh2",
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
from repro.core.schedules import Periodic
from repro.launch.mesh import make_mesh
from repro.launch.train import train_consensus_lm
from repro.models import registry
from repro.optim import cosine_lr, sgd

out = {spec["problem"]["params"]["arch"]:
       repro.run(repro.ExperimentSpec.from_dict(spec)).to_dict()
       for spec in json.loads(sys.argv[1])}
rep = train_consensus_lm(
    registry.get_config("deepseek-v2-236b", "smoke"),
    sgd(cosine_lr(3e-4, 6)), make_mesh((2, 1, 1), ("pod", "data", "model")),
    steps=6, schedule=Periodic(h=2), topology="complete",
    batch_per_node=2, seq_len=32, seed=0, log_every=0)
out["sgd"] = {"losses": rep.losses, "comm_rounds": rep.comm_rounds,
              "sim_time_units": rep.sim_time_units,
              "param_bytes": rep.extras["param_bytes"]}
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
                           device=CPU).to_dict()
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


def test_sgd_entry_point_matches_reference(reference_results):
    """The full-width card cell's entry point: `train_consensus_lm` with
    SGD without momentum (no optimizer state) on deepseek-v2's smoke
    width at mesh (2, 1, 1), against the reference's."""
    rep = train_consensus_lm(
        port_registry.get_config("deepseek-v2-236b", "smoke"),
        port_optim.sgd(port_optim.cosine_lr(3e-4, 6)),
        make_mesh((2, 1, 1), ("pod", "data", "model"), device=CPU),
        steps=6, schedule=Periodic(h=2), topology="complete",
        batch_per_node=BATCH, seq_len=SEQ, seed=0, log_every=0)
    ref = reference_results["sgd"]
    assert (rep.comm_rounds, rep.sim_time_units,
            rep.extras["param_bytes"]) == (ref["comm_rounds"],
                                           ref["sim_time_units"],
                                           ref["param_bytes"])
    np.testing.assert_allclose(rep.losses, ref["losses"], rtol=TRACE_RTOL)


def _first_batch(cfg, pod: int) -> np.ndarray:
    stream = TokenStream(cfg.vocab_size, SEQ, BATCH, node_index=pod,
                         num_nodes=2, seed=0, device=CPU)
    try:
        return next(stream)["tokens"].numpy()
    finally:
        stream.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_router_residue_and_first_step_flips_are_counted(arch, monkeypatch):
    """Each pod's parameters as the two launchers draw them (one key a pod
    from `split(PRNGKey(0), 2)`): every leaf equal but the routers, whose
    differing elements are counted; then each pod's first forward on its
    first batch, each package on its own parameters, with the router
    choices that differ counted."""
    cfg_r = ref_registry.get_config(arch, "smoke")
    cfg_t = port_registry.get_config(arch, "smoke")
    ref_keys = jax.random.split(jax.random.PRNGKey(0), 2)
    port_keys = prng.split(prng.key(0), 2)

    ref_choices = record_reference_choices(monkeypatch)
    port_choices = record_port_choices(monkeypatch)

    differ = total = max_ulps = 0
    flips, choices = [], 0
    for pod in range(2):
        ref = jax.jit(lambda k: ref_tf.init(k, cfg_r)[0])(ref_keys[pod])
        ours, _ = port_tf.init(port_keys[pod], cfg_t)
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
            mine = ours
            for k in path:
                mine = mine[k.key] if hasattr(k, "key") else mine[k.idx]
            a = np.asarray(leaf)
            if "router" in jax.tree_util.keystr(path):
                ulps = np.abs(mine.numpy().view(np.int32).astype(np.int64)
                              - a.view(np.int32).astype(np.int64))
                differ += int((ulps > 0).sum())
                total += ulps.size
                max_ulps = max(max_ulps, int(ulps.max()))
            elif a.dtype == np.float32:
                np.testing.assert_array_equal(mine.numpy(), a)
            else:
                np.testing.assert_array_equal(
                    mine.view(torch.uint16).numpy(), a.view(np.uint16))
        tokens = _first_batch(cfg_t, pod)
        ref_choices.clear()
        port_choices.clear()
        jax.jit(ref_tf.forward, static_argnums=2)(ref, jnp.asarray(tokens),
                                                 cfg_r)
        jax.effects_barrier()
        with torch.no_grad():
            port_tf.forward(ours, torch.from_numpy(tokens), cfg_t)
        assert len(ref_choices) == len(port_choices) == cfg_t.n_super
        flips += [int((a != b).sum())
                  for a, b in zip(ref_choices, port_choices)]
        choices = ref_choices[0].size
    assert max_ulps <= 3 and differ < 0.02 * total, (differ, total)
    assert max(flips) <= 0.05 * choices, flips
