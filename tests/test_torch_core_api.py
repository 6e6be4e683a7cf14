"""The remnants of the reference's core and runtime API in the port, on the
CPU: the per-node DDA pytree step (`DDAState`, `dda_init`,
`dda_local_step`), `tree_mix_dense` and `mix_params_dense`, the flat
error-feedback top-k API of `core.compression`, elastic rescaling
(`plan_rescale`, `rescale_state`) and the straggler math
(`StragglerModel`, `degraded_matrix`, `effective_round_time`).

Each is held to the reference's own cases (`tests/test_dda.py`,
`tests/test_consensus.py`, `tests/test_fault_tolerance.py`), run on the
port, and to the reference's function on the same inputs:
  * host numpy (the straggler draws, degraded matrices, round times,
    rescale plans and the rescaled state): bits equal;
  * the dense mixes: rtol 1e-6, atol 1e-7 (torch's and XLA's matmuls sum
    in their own orders);
  * the DDA step and the flat top-k with error feedback: float32 bits
    equal (the reference's eager ops round each product, as the port
    does), top-k ties toward the lower index.
Trees are built with their keys in sorted order, so that torch's leaf
order is jax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as ref_comp
from repro.core import consensus as ref_cons
from repro.core import consensus_sgd as ref_csgd
from repro.core import dda as ref_dda
from repro.core import graphs as ref_graphs
from repro.runtime import elastic as ref_elastic
from repro.runtime import fault_tolerance as ref_ft

import repro_torch.core as core
import repro_torch.runtime as runtime
from repro_torch.core import graphs as port_graphs

from _hyp import given, st


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# DDA pytree step (tests/test_dda.py)
# ---------------------------------------------------------------------------


def test_dda_local_step_pure():
    x0 = {"w": torch.ones((3,))}
    state = core.dda_init(x0)
    grad = {"w": torch.full((3,), 2.0)}
    a_fn = core.stepsize_sqrt(0.1)
    s1 = core.dda_local_step(state, grad, a_fn)
    np.testing.assert_allclose(s1.z["w"].numpy(), 2.0)
    np.testing.assert_allclose(s1.x["w"].numpy(), -0.1 * 2.0, rtol=1e-6)
    # running average after first step equals x(1)
    np.testing.assert_allclose(s1.xhat["w"].numpy(), s1.x["w"].numpy(),
                               rtol=1e-6)
    # the state given is left as it was
    assert float(state.t) == 0.0 and torch.equal(state.z["w"],
                                                 torch.zeros(3))


def test_dda_steps_are_the_reference_bits():
    """Five local steps on a tree with a list and a projection, against the
    reference's step on the same float32 inputs: every leaf's bits."""
    rng = np.random.default_rng(0)
    x0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": [rng.normal(size=(5,)).astype(np.float32)]}
    grads = [{"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
             for _ in range(5)]

    def clip(tree, lib):
        return jax.tree.map(lambda v: lib.clip(v, -0.3, 0.3), tree) \
            if lib is jnp else torch.utils._pytree.tree_map(
                lambda v: torch.clamp(v, -0.3, 0.3), tree)
    ref = ref_dda.dda_init(jax.tree.map(jnp.asarray, x0))
    ours = core.dda_init(torch.utils._pytree.tree_map(_t, x0))
    for g in grads:
        ref = ref_dda.dda_local_step(ref, jax.tree.map(jnp.asarray, g),
                                     ref_dda.stepsize_sqrt(0.7),
                                     lambda x: clip(x, jnp))
        ours = core.dda_local_step(ours, torch.utils._pytree.tree_map(_t, g),
                                   core.stepsize_sqrt(0.7),
                                   lambda x: clip(x, torch))
    assert isinstance(ours, core.DDAState) and ours.t.dtype == torch.float32
    assert float(ours.t) == float(ref.t) == 5.0
    for field in ("z", "x", "xhat"):
        for a, b in zip(jax.tree.leaves(getattr(ref, field)),
                        torch.utils._pytree.tree_leaves(getattr(ours,
                                                                field))):
            np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                          np.asarray(a).view(np.uint32))


# ---------------------------------------------------------------------------
# dense tree mixes (tests/test_consensus.py)
# ---------------------------------------------------------------------------


def test_tree_mix_dense():
    g = port_graphs.complete_graph(4)
    tree = {"a": torch.arange(8.0).reshape(4, 2), "b": torch.ones((4, 3))}
    out = core.tree_mix_dense(tree, g.mixing_matrix())
    np.testing.assert_allclose(out["a"].numpy(),
                               np.tile(tree["a"].numpy().mean(0), (4, 1)),
                               atol=1e-6)
    np.testing.assert_allclose(out["b"].numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ["ring", "expander4", "complete"])
def test_mix_params_dense_matches_reference(name):
    rng = np.random.default_rng(1)
    tree = {"v": [rng.normal(size=(8,)).astype(np.float32)],
            "w": rng.normal(size=(8, 3, 2)).astype(np.float32)}
    ref = ref_csgd.mix_params_dense(jax.tree.map(jnp.asarray, tree),
                                    ref_graphs.build_graph(name, 8))
    cfg = core.ConsensusConfig(port_graphs.build_graph(name, 8))
    assert cfg.axis_name == "pod"
    ours = core.mix_params_dense(torch.utils._pytree.tree_map(_t, tree),
                                 cfg.graph)
    for a, b in zip(jax.tree.leaves(ref),
                    torch.utils._pytree.tree_leaves(ours)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    # the single-leaf oracle of tests/test_consensus.py, on the port
    np.testing.assert_allclose(
        core.tree_mix_dense(torch.utils._pytree.tree_map(_t, tree),
                            cfg.graph.mixing_matrix())["w"].numpy(),
        np.asarray(ref_cons.tree_mix_dense(
            jax.tree.map(jnp.asarray, tree),
            ref_graphs.build_graph(name, 8).mixing_matrix())["w"]),
        rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# flat error-feedback top-k (tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------


def test_error_feedback_accumulates_everything():
    """Over T rounds, sum(sent) + residual == sum(messages): EF loses
    nothing permanently."""
    rng = np.random.default_rng(0)
    msgs = [_t(rng.normal(size=(32,))) for _ in range(10)]
    state = core.ef_init(msgs[0])
    total_sent = torch.zeros(32)
    for m in msgs:
        sent, state = core.ef_compress(m, state, keep_fraction=0.1)
        total_sent = total_sent + sent
    np.testing.assert_allclose((total_sent + state.residual).numpy(),
                               sum(msgs).numpy(), atol=1e-5)


def test_ratio_bytes():
    assert np.isclose(core.ratio_bytes(0.01, 4, 4), 0.02)
    assert np.isclose(core.ratio_bytes(0.05, 8, 4), 0.075)
    assert core.ratio_bytes(0.25) == ref_comp.ratio_bytes(0.25)


def test_flat_topk_and_error_feedback_are_the_reference_bits():
    """Ten rounds on a tree whose messages carry magnitude ties (values
    drawn from a few levels): sent messages, residuals and the support of
    `topk_compress` equal the reference's, ties to the lower index."""
    rng = np.random.default_rng(3)
    levels = np.array([-1.5, -0.5, 0.5, 1.5, 0.25], np.float32)
    msgs = [{"a": levels[rng.integers(0, 5, (6, 7))],
             "b": [levels[rng.integers(0, 5, (13,))]]} for _ in range(10)]
    vals, idx = core.topk_compress(_t(msgs[0]["a"]), 9)
    ref_vals, ref_idx = ref_comp.topk_compress(jnp.asarray(msgs[0]["a"]), 9)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    np.testing.assert_array_equal(
        core.topk_decompress(vals, idx, (6, 7)).numpy(),
        np.asarray(ref_comp.topk_decompress(ref_vals, ref_idx, (6, 7))))
    ref_state = ref_comp.ef_init(jax.tree.map(jnp.asarray, msgs[0]))
    state = core.ef_init(torch.utils._pytree.tree_map(_t, msgs[0]))
    assert isinstance(state, core.CompressionState)
    for m in msgs:
        ref_sent, ref_state = ref_comp.ef_compress(
            jax.tree.map(jnp.asarray, m), ref_state, keep_fraction=0.2)
        sent, state = core.ef_compress(torch.utils._pytree.tree_map(_t, m),
                                       state, keep_fraction=0.2)
        for a, b in zip(jax.tree.leaves((ref_sent, ref_state.residual)),
                        torch.utils._pytree.tree_leaves(
                            (sent, state.residual))):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# straggler math and elastic rescale (tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------


@given(seed=st.integers(0, 20))
def test_degraded_matrix_row_stochastic(seed):
    g = port_graphs.random_regular_expander(10, k=4, seed=0)
    rng = np.random.default_rng(seed)
    arrived = rng.random(10) > 0.3
    P = runtime.degraded_matrix(g, arrived)
    assert np.allclose(P.sum(axis=1), 1.0, atol=1e-9)
    assert (P >= -1e-12).all()
    for j in range(10):
        if not arrived[j]:
            col = P[:, j].copy()
            col[j] = 0.0
            assert np.allclose(col, 0.0)
    np.testing.assert_array_equal(P, ref_ft.degraded_matrix(
        ref_graphs.random_regular_expander(10, k=4, seed=0), arrived))


def test_consensus_with_random_drops_still_converges():
    g = port_graphs.random_regular_expander(12, k=4, seed=1)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(12, 5)).astype(np.float64)
    for _ in range(300):
        arrived = rng.random(12) > 0.3
        z = runtime.degraded_matrix(g, arrived) @ z
    assert np.max(np.std(z, axis=0)) < 1e-3


def test_straggler_model_deadline():
    m = runtime.StragglerModel(p_slow=0.5, m_slow=8.0, deadline=2.0, seed=0)
    times = m.sample_round(1000)
    assert set(np.unique(times)) <= {1.0, 8.0}
    mask = m.arrival_mask(1000)
    assert 0.3 < mask.mean() < 0.7


def test_straggler_draws_are_the_reference_stream():
    """The same seed gives the reference's draws, round after round, and
    the same deadline-gossip round times."""
    kw = dict(p_slow=0.3, m_slow=4.0, deadline=2.0, seed=11)
    ours, ref = runtime.StragglerModel(**kw), ref_ft.StragglerModel(**kw)
    for n in (64, 7, 64):
        t_ours, t_ref = ours.sample_round(n), ref.sample_round(n)
        np.testing.assert_array_equal(t_ours, t_ref)
        np.testing.assert_array_equal(ours.arrival_mask(n),
                                      ref.arrival_mask(n))
        for deadline, cost in ((2.0, 0.5), (8.0, 0.0), (0.5, 1.25)):
            assert runtime.effective_round_time(t_ours, deadline, cost) == \
                ref_ft.effective_round_time(t_ref, deadline, cost)
    assert runtime.effective_round_time(np.array([1.0, 4.0]), 2.0,
                                        0.5) == 2.5


def test_straggler_arrival_mask_seeded_determinism():
    a = runtime.StragglerModel(p_slow=0.3, m_slow=4.0, deadline=2.0, seed=11)
    b = runtime.StragglerModel(p_slow=0.3, m_slow=4.0, deadline=2.0, seed=11)
    c = runtime.StragglerModel(p_slow=0.3, m_slow=4.0, deadline=2.0, seed=12)
    seq_a = [a.arrival_mask(64) for _ in range(5)]
    seq_b = [b.arrival_mask(64) for _ in range(5)]
    seq_c = [c.arrival_mask(64) for _ in range(5)]
    for ma, mb in zip(seq_a, seq_b):
        np.testing.assert_array_equal(ma, mb)
    assert any(not np.array_equal(ma, mc) for ma, mc in zip(seq_a, seq_c))
    assert any(not np.array_equal(seq_a[0], m) for m in seq_a[1:])


def test_elastic_rescale_shrink_and_grow():
    state = {"w": torch.arange(8.0).reshape(4, 2)}
    plan = runtime.plan_rescale("complete", 4, 3, m_rows=120, failed=[1])
    out = runtime.rescale_state(state, plan)
    assert out["w"].shape == (3, 2) and out["w"].dtype == torch.float32
    np.testing.assert_allclose(out["w"][0].numpy(), [0, 1])
    np.testing.assert_allclose(out["w"][1].numpy(), [4, 5])
    plan2 = runtime.plan_rescale("complete", 3, 5, m_rows=120)
    out2 = runtime.rescale_state({"w": out["w"]}, plan2)
    assert out2["w"].shape == (5, 2)
    np.testing.assert_allclose(out2["w"][3].numpy(),
                               out["w"].numpy().mean(0), rtol=1e-6)
    assert sum(s.stop - s.start for s in plan2.data_slices) == 120


@pytest.mark.parametrize("topology,old_n,new_n,failed", [
    ("complete", 4, 3, [1]), ("expander", 9, 6, [0, 4, 7]),
    ("ring", 5, 8, [])])
def test_rescale_matches_reference(topology, old_n, new_n, failed):
    rng = np.random.default_rng(old_n)
    state = {"b": [rng.normal(size=(old_n,)).astype(np.float32)],
             "w": rng.normal(size=(old_n, 3)).astype(np.float32)}
    kw = dict(m_rows=101, failed=failed, k=4, seed=2)
    ref_plan = ref_elastic.plan_rescale(topology, old_n, new_n, **kw)
    plan = runtime.plan_rescale(topology, old_n, new_n, **kw)
    assert isinstance(plan, runtime.RescalePlan)
    assert (plan.old_n, plan.new_n, plan.survivor_ids, plan.data_slices) == (
        ref_plan.old_n, ref_plan.new_n, ref_plan.survivor_ids,
        ref_plan.data_slices)
    np.testing.assert_array_equal(plan.graph.mixing_matrix(),
                                  ref_plan.graph.mixing_matrix())
    ref = ref_elastic.rescale_state(jax.tree.map(jnp.asarray, state),
                                    ref_plan)
    ours = runtime.rescale_state(torch.utils._pytree.tree_map(_t, state),
                                 plan)
    for a, b in zip(jax.tree.leaves(ref),
                    torch.utils._pytree.tree_leaves(ours)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_plan_rescale_rejects_out_of_range_failed_ids():
    with pytest.raises(ValueError, match=r"failed ids \[4\] out of range"):
        runtime.plan_rescale("complete", 4, 3, m_rows=100, failed=[4])
    with pytest.raises(ValueError, match="out of range"):
        runtime.plan_rescale("complete", 4, 3, m_rows=100, failed=[-1])


def test_plan_rescale_rejects_all_failed():
    with pytest.raises(ValueError, match="no survivors"):
        runtime.plan_rescale("complete", 3, 3, m_rows=100, failed=[0, 1, 2])


def test_elastic_rescale_grow_from_single_survivor():
    state = {"w": torch.arange(6.0).reshape(3, 2)}
    plan = runtime.plan_rescale("complete", 3, 4, m_rows=40, failed=[0, 2])
    out = runtime.rescale_state(state, plan)
    assert out["w"].shape == (4, 2)
    for i in range(4):
        np.testing.assert_allclose(out["w"][i].numpy(), [2, 3])
