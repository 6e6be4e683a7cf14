"""The port's launch backend against the JAX package's, on the CPU: the
token stream, the pod mix (`core.consensus.tree_mix_gossip`, K1's plain
version here), the consensus steps (mixing the parameters, or the dual
state z with `mix_target="z"`), a whole launch run at mesh (2, 1, 1),
a checkpoint the reference wrote resumed by the port, the dry-run
manifest, and the mesh's refusal of sharded pods.

Standards (PERF.md and ROADMAP queue 3 give the observed errors):
  * token batches, the host fields of a run (iters, sim_time, comms,
    comm_rounds, sim_time_units, msgs, bytes_on_wire, gossip_rounds,
    param_bytes, step_comm) and the dry-run's extras: exact;
  * the mix on the complete graph at n = 2: bit for bit (weights 1/2);
    expander n = 4, k = 2: rtol 1e-6, atol 1e-7 in float32 (observed
    2.0e-8 where a sum cancels: K1's summation order is not the einsum's),
    one bf16 ulp in bf16;
  * one local step in float32: losses and gradient norms rtol 1e-6,
    parameters atol 2e-5 (observed 0 flipped update signs, 8.2e-6: AdamW's
    first step is about lr * sign(g)); in bf16: losses rtol 3e-4 (observed
    1.5e-4), gradient norms rtol 1e-3 (3.9e-4), parameters atol 2e-3
    (9.8e-4) with at most 0.5% of update signs flipped (observed 1,431 of
    820,480, 0.17%);
  * a 6-step bf16 loss trace and a resumed trace: rtol 5e-4 (observed
    1.36e-4, at the first step, and 4.1e-5).
"""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import optim as ref_optim
from repro.core import graphs as ref_graphs
from repro.data.pipeline import TokenStream as RefTokenStream
from repro.launch import steps as ref_steps
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf

import repro_torch
from repro_torch import optim as port_optim
from repro_torch.convert import (assert_results_match,
                                 lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.core import graphs as port_graphs
from repro_torch.core.consensus import tree_mix_gossip
from repro_torch.core.schedules import Periodic
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import steps as port_steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train_consensus_lm
from repro_torch.models import registry as port_registry

REPO = pathlib.Path(__file__).resolve().parents[1]
MANIFESTS = REPO / "benchmarks" / "manifests"
CPU = torch.device("cpu")
AXES = ("pod", "data", "model")
TRACE_RTOL = 5e-4

#: the launch spec both packages run at mesh (2, 1, 1)
SPEC = {
    "name": "lm_mesh2",
    "problem": {"kind": "lm", "params": {"arch": "llama3-8b",
                                         "variant": "smoke",
                                         "batch_per_node": 2,
                                         "seq_len": 32}},
    "topology": {"kind": "complete", "params": {}},
    "schedule": {"kind": "periodic", "params": {"h": 2}},
    "backends": [{"kind": "launch", "params": {"mesh": [2, 1, 1]}}],
    "T": 6, "eval_every": 1, "seed": 0, "r": 0.05,
}
#: the checkpoint run: 4 steps saved every 2, then resumed to 6
CKPT = dict(batch_per_node=2, seq_len=32, seed=0, log_every=0)

_REFERENCE_SCRIPT = """
import json, shutil, sys
import repro
from repro.core.schedules import Periodic
from repro.launch.mesh import make_mesh
from repro.launch.train import train_consensus_lm
from repro.models import registry
from repro.optim import adamw, cosine_lr

spec_json, written, copy = sys.argv[1:4]
out = {"result": repro.run(repro.ExperimentSpec.from_json(spec_json))
       .to_dict()}
cfg = registry.get_config("llama3-8b", "smoke")
mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
kw = dict(schedule=Periodic(h=2), ckpt_every=2, **json.loads(sys.argv[4]))
train_consensus_lm(cfg, adamw(cosine_lr(3e-4, 6)), mesh, steps=4,
                   ckpt_dir=written, **kw)
shutil.copytree(written, copy)
rep = train_consensus_lm(cfg, adamw(cosine_lr(3e-4, 6)), mesh, steps=6,
                         ckpt_dir=written, **kw)
out["resume"] = {"resumed_from": rep.resumed_from, "losses": rep.losses}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """`repro.run` of SPEC, and the reference's checkpoint run, in one
    subprocess with two host devices (its mesh needs them); the port
    resumes from a copy of the checkpoints the reference wrote."""
    tmp = tmp_path_factory.mktemp("lm_ckpt")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = f"{REPO / 'src'}:{REPO}"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE_SCRIPT),
         json.dumps(SPEC), str(tmp / "written"), str(tmp / "copy"),
         json.dumps(CKPT)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    data = json.loads(line[-1][len("RESULT "):])
    data["copy"] = tmp / "copy"
    return data


def test_token_stream_is_the_reference_bits():
    for node in range(3):
        ref = RefTokenStream(512, 16, 3, node_index=node, num_nodes=3,
                             seed=5)
        port = TokenStream(512, 16, 3, node_index=node, num_nodes=3,
                           seed=5, device=CPU)
        try:
            for _ in range(3):
                a, b = next(ref), next(port)
                for key in ("tokens", "labels"):
                    assert b[key].dtype == torch.int32
                    assert b[key].device == CPU
                    np.testing.assert_array_equal(b[key].numpy(),
                                                  np.asarray(a[key]))
        finally:
            ref.close()
            port.close()
        assert not port._thread.is_alive()


def _leaves(rng):
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "norm": rng.normal(size=(7,)).astype(np.float32)}


def _dense_mix(tree, graph):
    """`repro.launch.steps`' `_dense_mix`: the einsum with P over the pod
    dimension, in float32, back in each leaf's dtype."""
    P = jnp.asarray(graph.mixing_matrix(), jnp.float32)
    return jax.tree.map(
        lambda a: jnp.einsum("pq,q...->p...", P, a.astype(jnp.float32))
        .astype(a.dtype), tree)


@pytest.mark.parametrize("name,n,exact", [("complete", 2, True),
                                          ("expander2", 4, False)])
def test_tree_mix_gossip_matches_dense_mix(name, n, exact):
    rng = np.random.default_rng(0)
    stacked = {k: np.stack([_leaves(np.random.default_rng(i))[k]
                            for i in range(n)])
               for k in _leaves(rng)}
    ref_tree = {"w": jnp.asarray(stacked["w"], jnp.bfloat16),
                "norm": jnp.asarray(stacked["norm"], jnp.float32)}
    ref = _dense_mix(ref_tree, ref_graphs.build_graph(name, n))
    port_tree = lm_params_from_reference(jax.tree.map(np.asarray, ref_tree),
                                         device=CPU)
    ours = tree_mix_gossip(port_tree, port_graphs.build_graph(name, n),
                           device=CPU)
    ours = lm_params_to_reference(ours)
    for key in ("w", "norm"):
        a, b = np.asarray(ref[key]), ours[key]
        assert a.dtype == b.dtype
        if exact:
            np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))
        else:
            np.testing.assert_allclose(b.astype(np.float32),
                                       a.astype(np.float32), rtol=1e-6,
                                       atol=1e-7 if key == "norm" else 1e-2)
    one = tree_mix_gossip({"w": torch.ones(1, 4)},
                          port_graphs.build_graph("complete", 1), device=CPU)
    assert torch.equal(one["w"], torch.ones(1, 4))


def _pod_stacked_start(cfg_r, opt_r, n):
    def one(k):
        params, _ = ref_tf.init(k, cfg_r)
        return params, opt_r.init(params)
    return jax.jit(jax.vmap(one))(jax.random.split(jax.random.PRNGKey(0), n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_and_fused_match_vmapped_reference(dtype):
    n = 2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cfg_r = dataclasses.replace(ref_registry.get_config("llama3-8b",
                                                        "smoke"), dtype=jdt)
    cfg_t = dataclasses.replace(port_registry.get_config("llama3-8b",
                                                         "smoke"), dtype=tdt)
    opt_r = ref_optim.adamw(ref_optim.cosine_lr(3e-4, 6))
    opt_t = port_optim.adamw(port_optim.cosine_lr(3e-4, 6))
    start = _pod_stacked_start(cfg_r, opt_r, n)
    toks = np.random.default_rng(0).integers(
        0, cfg_r.vocab_size, (n, 2, 33)).astype(np.int32)
    batch_r = {"tokens": jnp.asarray(toks[..., :-1]),
               "labels": jnp.asarray(toks[..., 1:])}
    batch_t = {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in batch_r.items()}
    local_r = jax.jit(jax.vmap(ref_steps.make_train_step(cfg_r, opt_r)))
    p_ref, s_ref, m_ref = local_r(*start, batch_r)
    graph = ref_graphs.complete_graph(n)
    mixed_ref = _dense_mix(p_ref, graph)

    local, mix, fused = port_steps.make_consensus_steps(
        cfg_t, opt_t, port_graphs.complete_graph(n),
        make_mesh((n, 1, 1), AXES, device=CPU))
    tight = dtype == "float32"
    for step_fn, want in ((local, p_ref), (fused, mixed_ref)):
        p0, s0 = lm_params_from_reference(jax.tree.map(np.asarray, start),
                                          device=CPU)
        p1, s1, m = step_fn(p0, s0, batch_t)
        assert m["loss"].shape == m["grad_norm"].shape == (n,)
        np.testing.assert_allclose(m["loss"].numpy(), m_ref["loss"],
                                   rtol=1e-6 if tight else 3e-4)
        np.testing.assert_allclose(m["grad_norm"].numpy(),
                                   m_ref["grad_norm"],
                                   rtol=1e-6 if tight else 1e-3)
        assert s1.step.tolist() == [1] * n
        flips = total = 0
        for a, b, a0 in zip(jax.tree.leaves(want),
                            jax.tree.leaves(lm_params_to_reference(p1)),
                            jax.tree.leaves(start[0])):
            a, b, a0 = (np.asarray(x, np.float32) for x in (a, b, a0))
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=2e-5 if tight else 2e-3)
            flips += int((np.sign(b - a0) != np.sign(a - a0)).sum())
            total += a.size
        if step_fn is local:  # AdamW's first step: about lr * sign(g)
            assert flips == 0 if tight else flips <= 0.005 * total
        else:  # complete n=2: the pods agree bit for bit
            for leaf in jax.tree.leaves(p1):
                assert torch.equal(leaf[0], leaf[1])


def test_fused_step_mixing_z_matches_reference():
    """mix_target="z", the faithful DDA mode: a fused step with the
    dual_averaging optimizer at complete n = 4 in float32 mixes the dual
    state z (K1's plain version) and leaves the parameters as the local
    step set them, as the reference's fused step does (observed z 4.1e-8
    apart at a largest 0.071, parameters 6.0e-8: K1's summation order is
    not the einsum's)."""
    n = 4
    cfg_r = dataclasses.replace(ref_registry.get_config("llama3-8b",
                                                        "smoke"),
                                dtype=jnp.float32)
    cfg_t = dataclasses.replace(port_registry.get_config("llama3-8b",
                                                         "smoke"),
                                dtype=torch.float32)
    opt_r = ref_optim.dual_averaging(ref_optim.rsqrt_lr(0.5, q=0.7))
    opt_t = port_optim.dual_averaging(port_optim.rsqrt_lr(0.5, q=0.7))
    start = _pod_stacked_start(cfg_r, opt_r, n)
    toks = np.random.default_rng(2).integers(
        0, cfg_r.vocab_size, (n, 2, 17)).astype(np.int32)
    batch_r = {"tokens": jnp.asarray(toks[..., :-1]),
               "labels": jnp.asarray(toks[..., 1:])}
    batch_t = {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in batch_r.items()}
    local_r = jax.jit(jax.vmap(ref_steps.make_train_step(cfg_r, opt_r)))
    p_ref, s_ref, m_ref = local_r(*start, batch_r)
    z_ref = _dense_mix(s_ref.inner["z"], ref_graphs.complete_graph(n))
    _, _, fused = port_steps.make_consensus_steps(
        cfg_t, opt_t, port_graphs.complete_graph(n),
        make_mesh((n, 1, 1), AXES, device=CPU), mix_target="z")
    p0, s0 = lm_params_from_reference(jax.tree.map(np.asarray, start),
                                      device=CPU)
    p1, s1, m = fused(p0, s0, batch_t)
    np.testing.assert_allclose(m["loss"].numpy(), m_ref["loss"], rtol=1e-6)
    assert s1.step.tolist() == [1] * n
    for a, b in zip(jax.tree.leaves(z_ref),
                    jax.tree.leaves(lm_params_to_reference(s1.inner["z"]))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree.leaves(p_ref),
                    jax.tree.leaves(lm_params_to_reference(p1))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=2e-5)
    # mixed: every pod holds the same z
    for leaf in jax.tree.leaves(s1.inner["z"]):
        assert torch.allclose(leaf[0], leaf[3], rtol=1e-6, atol=1e-7)


def test_microbatched_train_step_matches_reference():
    cfg_r = dataclasses.replace(ref_registry.get_config("llama3-8b",
                                                        "smoke"),
                                dtype=jnp.float32)
    cfg_t = dataclasses.replace(port_registry.get_config("llama3-8b",
                                                         "smoke"),
                                dtype=torch.float32)
    opt_r = ref_optim.sgd(ref_optim.constant_lr(0.05))
    opt_t = port_optim.sgd(port_optim.constant_lr(0.05))
    params_r, _ = ref_tf.init(jax.random.PRNGKey(4), cfg_r)
    toks = np.random.default_rng(4).integers(0, 512, (4, 17)).astype(
        np.int32)
    batch_r = {"tokens": jnp.asarray(toks[:, :-1]),
               "labels": jnp.asarray(toks[:, 1:])}
    step_r = jax.jit(ref_steps.make_train_step(cfg_r, opt_r, microbatches=2))
    p_ref, _, m_ref = step_r(params_r, opt_r.init(params_r), batch_r)
    params_t = lm_params_from_reference(jax.tree.map(np.asarray, params_r),
                                        device=CPU)
    batch_t = {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in batch_r.items()}
    step_t = port_steps.make_train_step(cfg_t, opt_t, microbatches=2)
    p_t, _, m_t = step_t(params_t, opt_t.init(params_t), batch_t)
    assert float(m_t["loss"]) == pytest.approx(float(m_ref["loss"]),
                                               rel=1e-6)
    assert float(m_t["grad_norm"]) == pytest.approx(
        float(m_ref["grad_norm"]), rel=1e-5)
    for a, b in zip(jax.tree.leaves(p_ref),
                    jax.tree.leaves(lm_params_to_reference(p_t))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)


def test_run_at_mesh_2_matches_reference(reference_runs):
    spec = repro_torch.ExperimentSpec.from_dict(SPEC)
    ours = repro_torch.run(spec, device=CPU).to_dict()
    ref = reference_runs["result"]
    trace_ref = ref["trace"]
    np.testing.assert_allclose(ours["trace"]["fvals"], trace_ref["fvals"],
                               rtol=TRACE_RTOL)
    np.testing.assert_allclose(ours["trace"]["fvals_consensus"],
                               trace_ref["fvals_consensus"],
                               rtol=TRACE_RTOL)
    # host fields and extras exact, timings present: the parity check with
    # the loss columns taken as the reference's
    ours["trace"]["fvals"] = trace_ref["fvals"]
    ours["trace"]["fvals_consensus"] = trace_ref["fvals_consensus"]
    assert_results_match(ours, ref)
    assert ours["extras"]["step_comm"] == [False, False, True, False,
                                           True, False]
    assert ours["metrics"]["msgs"] == 2 * 2 * 1


def test_reference_checkpoint_resumes_on_the_port(reference_runs):
    cfg = port_registry.get_config("llama3-8b", "smoke")
    mesh = make_mesh((2, 1, 1), AXES, device=CPU)
    rep = train_consensus_lm(cfg, port_optim.adamw(port_optim.cosine_lr(
        3e-4, 6)), mesh, steps=6, schedule=Periodic(h=2),
        ckpt_dir=str(reference_runs["copy"]), ckpt_every=2, **CKPT)
    ref = reference_runs["resume"]
    assert rep.resumed_from == ref["resumed_from"] == 4
    assert len(rep.losses) == len(ref["losses"]) == 2
    np.testing.assert_allclose(rep.losses, ref["losses"], rtol=TRACE_RTOL)


def test_dryrun_manifest_extras_are_exact():
    spec = repro_torch.ExperimentSpec.from_file(
        MANIFESTS / "launch_dryrun.json")
    ours = repro_torch.run(spec, device=CPU).to_dict()
    ref = repro.run(repro.ExperimentSpec.from_file(
        MANIFESTS / "launch_dryrun.json")).to_dict()
    assert_results_match(ours, ref)
    for key in ("dryrun", "n_pods", "k", "param_bytes"):
        assert ours["extras"][key] == ref["extras"][key]
    assert ours["extras"]["k"] == 0 and ours["extras"]["n_pods"] == 1
    assert ours["trace"]["iters"] == []


@pytest.mark.parametrize("shape,case", [
    ((2, 2, 1), "no group"), ((1, 1, 2), "no group"),
    ((2, 2, 2), "wrong group"), ((1, 2, 2), "family")],
    ids=["shape0", "shape1", "wrong_group", "family"])
def test_mesh_refuses_sharded_pods(shape, case):
    """A sharded mesh without a process group names the groups it takes
    (`make_mesh` and `run`); a group of another size is refused; no
    family is refused (every one trains sharded,
    tests/test_torch_sharded_launch.py): the MoE family's dry-run on such
    a mesh traces its loss."""
    if case == "no group":
        shards = shape[1] * shape[2]
        with pytest.raises(ValueError, match=f"group=.*{shape[0] * shards} "
                                             f"ranks.*{shards} ranks"):
            make_mesh(shape, AXES, device=CPU)
        spec = repro_torch.ExperimentSpec.from_dict(
            {**SPEC, "backends": [{"kind": "launch",
                                   "params": {"mesh": list(shape)}}]})
        with pytest.raises(ValueError, match="needs a process group"):
            repro_torch.run(spec, device=CPU)
    elif case == "wrong group":
        import torch.distributed as dist

        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            with pytest.raises(ValueError, match="1 ranks but the mesh"):
                make_mesh(shape, AXES, device=CPU, group=dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    else:
        from repro_torch.launch.mesh import Mesh

        cfg = port_registry.get_config("deepseek-v2-236b", "smoke")
        rep = train_consensus_lm(cfg, port_optim.adamw(
            port_optim.cosine_lr(3e-4, 6)), Mesh(AXES, shape, CPU),
            steps=1, dryrun=True)
        assert rep.extras["dryrun"] and rep.steps == 0


def test_served_lm_spec_runs_solo_with_the_reference_reason():
    from repro.experiments.runner import batch_compat_report
    from repro_torch.convert import LAUNCH_TIMINGS
    from repro_torch.serve import ExperimentServer, comparable_result_dict

    path = MANIFESTS / "launch_dryrun.json"
    spec = repro_torch.ExperimentSpec.from_file(path)
    with ExperimentServer(workers=1, max_wait_s=0.01, device=CPU) as srv:
        served = srv.submit(spec).result(timeout=120)
    solo = repro_torch.run(spec, device=CPU)
    a, b = comparable_result_dict(served), comparable_result_dict(solo)
    for d in (a, b):
        for key in LAUNCH_TIMINGS:
            d["extras"].pop(key, None)
    assert a == b
    ref_spec = repro.ExperimentSpec.from_file(path)
    assert served.metrics.notes["solo_reason"] == batch_compat_report(
        ref_spec, ref_spec.backends[0])
