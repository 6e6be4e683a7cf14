"""The port's DDASimulator against the reference's: traces over problems x
topologies x schedules, a reweighted mix, the mix-mode resolution, a run
carried across from the reference mid-way, the float32 stepsize, and the
compressed runs (top-k, rand-k, int8, stochastic int8) on the sparse and
dense mixes.

Tolerances: trace floats and carried state rtol 1e-5, atol 1e-6, the
port's float32 tolerance (see PERF.md). The one exception is the int8
error-feedback residual, `corrected - dequant(q)`: the subtraction cancels
about 8 of float32's 24 bits (|res| <= s/2 = max|corrected|/254), so the
ulp-level differences the two packages' states carry (the stepsize's
rsqrt, XLA's FMA contraction) reach it about 254x larger. Its norms are
held to rtol 1e-4, its values to 1e-5 of the message's magnitude
(atol 1e-5 * max|corrected|). Every compressed comparison also counts the
flipped entries (a top-k support entry or an int8 code that differs
between the two runs) and requires none.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as ref_comp
from repro.core.dda import DDASimulator as RefSim
from repro.core.dda import stepsize_sqrt as ref_stepsize
from repro.experiments import components as ref_C

from repro_torch import compress as port_comp
from repro_torch.convert import state_from_reference
from repro_torch.core.dda import DDASimulator as PortSim
from repro_torch.core.dda import stepsize_sqrt as port_stepsize
from repro_torch.experiments import components as port_C

CPU = torch.device("cpu")
#: the port's float32 tolerance on trace floats (see PERF.md)
RTOL, ATOL = 1e-5, 1e-6

#: (kind, params, stepsize A): each A is in the problem's stable range --
#: past it the iterates blow up and float32 rounding grows with them
PROBLEMS = [
    ("quadratic_consensus", {"n": 8, "d": 16}, 0.5),
    ("least_squares", {"n": 8, "d": 12, "m_per_node": 20}, 0.02),
    ("nonsmooth", {"n": 8, "M": 6, "d": 10}, 0.004),
]
TOPOLOGIES = [("expander", {"k": 4}), ("complete", {})]
SCHEDULES = [("every", {}), ("periodic", {"h": 3}), ("sparse", {"p": 0.3})]

COMPRESSED = [("topk", {"keep": 0.25}), ("randk", {"keep": 0.25, "seed": 1}),
              ("int8", {}), ("int8", {"stochastic": True, "seed": 2})]
COMPRESSED_IDS = ["topk", "randk", "int8", "int8-stochastic"]
#: (topology, mix): the sparse K2/K1 path, the dense P_diag z + P_off sent
#: split on the same graph, and a complete graph (dense by resolution)
COMPRESSED_MIXES = [(("expander", {"k": 4}), "auto"),
                    (("expander", {"k": 4}), "dense"),
                    (("complete", {}), "auto")]
COMPRESSED_MIX_IDS = ["expander-sparse", "expander-dense", "complete"]
#: the int8 residual's tolerance (module docstring)
INT8_RES_RTOL = 1e-4


def _pair(problem, topology, schedule, r=0.05, compression=None, **sim_kw):
    """(reference simulator, port simulator, n, d) on the same spec;
    `compression` is a (kind, params) pair built on each side."""
    if compression is not None:
        sim_kw["compression"] = ref_comp.build_compressor(*compression)
    kind, params, A = problem
    ref_p = ref_C.build_component(ref_C.problems, kind, params)
    port_p = port_C.build_component(port_C.problems, kind, params,
                                    device=CPU)
    graph = ref_C.build_component(ref_C.topologies, *topology, n=ref_p.n)
    pgraph = port_C.build_component(port_C.topologies, *topology, n=ref_p.n)
    ref = RefSim(ref_p.subgrad_stack, jax.jit(ref_p.objective), graph,
                 ref_C.build_component(ref_C.schedules, *schedule),
                 a_fn=ref_stepsize(A), r=r, projection=ref_p.projection,
                 **sim_kw)
    if compression is not None:
        sim_kw["compression"] = port_comp.build_compressor(*compression)
    port = PortSim(port_p.subgrad_stack, port_p.objective, pgraph,
                   port_C.build_component(port_C.schedules, *schedule),
                   a_fn=port_stepsize(A), r=r, projection=port_p.projection,
                   device=CPU, **sim_kw)
    return ref, port, ref_p.n, ref_p.d


def _assert_traces_match(ours, theirs):
    assert ours.iters == theirs.iters
    assert ours.sim_time == theirs.sim_time
    assert ours.comms == theirs.comms
    for field in ("fvals", "fvals_consensus", "disagreement"):
        np.testing.assert_allclose(getattr(ours, field),
                                   getattr(theirs, field), rtol=RTOL,
                                   atol=ATOL, err_msg=field)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=[s[0] for s in SCHEDULES])
@pytest.mark.parametrize("topology", TOPOLOGIES, ids=[t[0] for t in TOPOLOGIES])
@pytest.mark.parametrize("problem", PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_trace_matches_reference(problem, topology, schedule):
    ref, port, n, d = _pair(problem, topology, schedule)
    assert port.mix_mode == ref.mix_mode
    assert port.mix_mode == ("sparse" if topology[0] == "expander"
                             else "dense")
    theirs = ref.run(jnp.zeros((n, d), jnp.float32), 60, eval_every=10)
    ours = port.run(torch.zeros((n, d)), 60, eval_every=10)
    _assert_traces_match(ours, theirs)
    assert port.last_timings["compile_s"] == 0.0  # no kernel build on CPU


def _edge_weights(graph, seed):
    rng = np.random.default_rng(seed)
    n = graph.n
    W = np.diag(rng.uniform(0.3, 0.6, n))
    for perm in graph.perms:
        for i, src in enumerate(perm):
            W[i, src] = rng.uniform(0.05, 0.15)
    return W


def test_mix_weights_override_matches_reference():
    """A reweighted P on the edge support takes the sparse path with
    per-edge weight vectors (the kernel's vector-weight route)."""
    problem = ("quadratic_consensus", {"n": 12, "d": 9}, 0.5)
    graph = ref_C.build_component(ref_C.topologies, "expander", {"k": 4},
                                  n=12)
    W = _edge_weights(graph, seed=4)
    ref, port, n, d = _pair(problem, ("expander", {"k": 4}),
                            ("periodic", {"h": 2}), mix_weights=W)
    assert port.mix_mode == ref.mix_mode == "sparse"
    assert port._w_self.shape == (12,) and port._w_edge.shape == (12, 4)
    theirs = ref.run(jnp.zeros((n, d), jnp.float32), 40, eval_every=10)
    ours = port.run(torch.zeros((n, d)), 40, eval_every=10)
    _assert_traces_match(ours, theirs)


def test_mix_mode_resolution_matches_reference():
    problem = ("quadratic_consensus", {"n": 12, "d": 4}, 0.5)
    graph = ref_C.build_component(ref_C.topologies, "expander", {"k": 4},
                                  n=12)
    W = _edge_weights(graph, seed=1)
    off_support = min(set(range(12)) - {0} - {p[0] for p in graph.perms})
    W[0, off_support] = 0.01
    ref, port, _, _ = _pair(problem, ("expander", {"k": 4}),
                            ("every", {}), mix_weights=W)
    assert port.mix_mode == ref.mix_mode == "dense"
    with pytest.raises(ValueError, match="sparse mix unavailable") as e_ref:
        _pair(problem, ("complete", {}), ("every", {}), mix="sparse")
    with pytest.raises(ValueError, match="mix must be"):
        _pair(problem, ("complete", {}), ("every", {}), mix="tiled")
    assert "complete" in str(e_ref.value)


def test_loops_agree():
    ref, port, n, d = _pair(PROBLEMS[0], TOPOLOGIES[0], SCHEDULES[1])
    scan = port.run(torch.zeros((n, d)), 45, eval_every=10, loop="scan")
    segment = port.run(torch.zeros((n, d)), 45, eval_every=10,
                       loop="segment")
    assert scan == segment
    assert port.last_timings["eval_s"] > 0.0
    assert len(scan.iters) == 5 and scan.iters[-1] == 45
    with pytest.raises(ValueError, match="loop must be"):
        port.run(torch.zeros((n, d)), 10, loop="vmap")
    empty = port.run(torch.zeros((n, d)), 0)
    assert dataclasses.asdict(empty) == dataclasses.asdict(
        ref.run(jnp.zeros((n, d), jnp.float32), 0))


def test_run_carried_across_from_the_reference():
    """Half a run on the reference, its carry moved into the port, the
    other half on both sides: the port continues where the reference
    stopped."""
    ref, port, n, d = _pair(PROBLEMS[0], TOPOLOGIES[0], ("periodic", {"h": 2}))
    T = 40
    mask = np.asarray(ref.schedule.comm_mask(0, T), dtype=bool)
    x0 = jnp.zeros((n, d), jnp.float32)
    root = jax.random.PRNGKey(0)
    carry = ref._segment(jnp.zeros_like(x0), x0, x0, jnp.zeros_like(x0),
                         jnp.float32(0.0), jnp.asarray(mask[:T // 2]),
                         jax.random.split(root, T // 2))
    arrays = dict(zip(("z", "x", "xhat", "res", "t"),
                      (np.asarray(a) for a in carry)))
    state = state_from_reference(arrays, device="cpu")
    ours = port._segment(*state, mask[T // 2:])
    theirs = ref._segment(*carry, jnp.asarray(mask[T // 2:]),
                          jax.random.split(jax.random.fold_in(root, T // 2),
                                           T // 2))
    assert float(ours[4]) == float(theirs[4]) == float(T)
    for name, a, b in zip(("z", "x", "xhat", "res"), ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_state_from_reference_checks_its_input():
    arrays = {f: np.zeros((3, 2), np.float32) for f in ("z", "x", "xhat",
                                                        "res")}
    with pytest.raises(KeyError, match="missing"):
        state_from_reference(arrays, device="cpu")
    arrays["t"] = np.float32(5.0)
    z, x, xhat, res, t = state_from_reference(arrays, device="cpu")
    assert t.dim() == 0 and float(t) == 5.0 and z.shape == (3, 2)
    arrays["x"] = np.zeros((3, 2), np.float64)
    with pytest.raises(TypeError, match="float32"):
        state_from_reference(arrays, device="cpu")


def test_stepsize_is_float32_on_tensors():
    """The reference traces a(t) on a float32 scalar, which XLA rewrites to
    A * rsqrt(t); its CPU rsqrt differs from the correctly rounded
    A / sqrt(t) the port computes by at most 2 ulp (ROADMAP, queue 3).
    Host numbers take the numpy path on both sides, bit for bit."""
    t = np.arange(1, 2001, dtype=np.float32)
    for A, q in ((0.5, 0.5), (0.0004, 0.5), (1.0, 0.7)):
        theirs = np.asarray(jax.jit(jax.vmap(ref_stepsize(A, q)))(
            jnp.asarray(t)))
        ours = port_stepsize(A, q)(torch.from_numpy(t))
        assert ours.dtype == torch.float32
        ulps = np.abs(ours.numpy().view(np.int32) - theirs.view(np.int32))
        assert ulps.max() <= 2
        host = t.astype(np.float64)
        np.testing.assert_array_equal(port_stepsize(A, q)(host),
                                      ref_stepsize(A, q)(host))


def test_compress_keep_with_compression_is_refused():
    """The legacy `compress_keep` alias together with `compression` is
    refused, with the reference's error."""
    from repro_torch.core.graphs import complete_graph

    for sim_cls, comp in ((PortSim, port_comp), (RefSim, ref_comp)):
        kw = {"device": CPU} if sim_cls is PortSim else {}
        with pytest.raises(ValueError, match="not both"):
            sim_cls(lambda x, t, k: x, lambda x: x.sum(), complete_graph(4),
                    compress_keep=0.5, compression=comp.TopK(keep=0.5), **kw)


def _flipped_entries(ref, port, n, d, T):
    """Run both simulators in lockstep, one iteration at a time, and count
    the transmitted codes that differ between them at each communication
    round: a support entry of a sparsifier, an int8 code. Both sides'
    corrected messages go through the port's compressor, which equals the
    reference's bit for bit (tests/test_torch_compress.py)."""
    comp = port.compression
    codes = (comp.support_mask_torch if comp.is_sparsifier
             else lambda c, t: comp.codes_torch(c, t)[0])
    mask = np.asarray(ref.schedule.comm_mask(0, T), dtype=bool)
    x0 = jnp.zeros((n, d), jnp.float32)
    theirs = (jnp.zeros_like(x0), x0, x0, jnp.zeros_like(x0),
              jnp.float32(0.0))
    ours = tuple(torch.zeros((n, d)) for _ in range(4)) + (
        torch.tensor(0.0),)
    keys = jax.random.split(jax.random.PRNGKey(0), 1)
    flips = 0
    for i in range(T):
        if mask[i]:
            ref_corrected = torch.from_numpy(
                np.asarray(theirs[0]) + np.asarray(theirs[3]))
            flips += int((codes(ours[0] + ours[3], ours[4])
                          != codes(ref_corrected, ours[4])).sum())
        theirs = ref._segment(*theirs, jnp.asarray(mask[i:i + 1]), keys)
        ours = port._segment(*ours, mask[i:i + 1])
    return flips


@pytest.mark.parametrize("topology,mix", COMPRESSED_MIXES,
                         ids=COMPRESSED_MIX_IDS)
@pytest.mark.parametrize("compression", COMPRESSED, ids=COMPRESSED_IDS)
def test_compressed_trace_matches_reference(compression, topology, mix):
    ref, port, n, d = _pair(PROBLEMS[0], topology, ("periodic", {"h": 2}),
                            compression=compression, mix=mix)
    assert port.mix_mode == ref.mix_mode
    assert port.wire_ratio(d) == ref.wire_ratio(d) < 1.0
    T = 60
    theirs = ref.run(jnp.zeros((n, d), jnp.float32), T, eval_every=10)
    ours = port.run(torch.zeros((n, d)), T, eval_every=10)
    _assert_traces_match(ours, theirs)  # sim_time exact: r * c on both
    rtol = INT8_RES_RTOL if compression[0] == "int8" else RTOL
    assert port.last_res_norms.shape == ref.last_res_norms.shape == (6,)
    assert np.all(port.last_res_norms > 0)
    np.testing.assert_allclose(port.last_res_norms, ref.last_res_norms,
                               rtol=rtol, atol=ATOL)
    assert _flipped_entries(ref, port, n, d, T) == 0


def test_compressed_expander_flips_no_support():
    """The manifest's configuration (top-k keep 1/8, n=16, d=64, T=300):
    the stepsize's rsqrt ulps and XLA's FMA contractions (ROADMAP queue 3)
    move the port's state by rounding, and not one support entry flips."""
    ref, port, n, d = _pair(
        ("quadratic_consensus", {"n": 16, "d": 64, "seed": 0}, 0.5),
        ("expander", {"k": 4, "seed": 0}), ("periodic", {"h": 2}), r=0.2,
        compression=("topk", {"keep": 0.125}))
    assert port.mix_mode == "sparse"
    assert _flipped_entries(ref, port, n, d, 300) == 0


def test_none_compressor_is_the_uncompressed_run():
    _, plain, n, d = _pair(PROBLEMS[0], TOPOLOGIES[0], ("periodic", {"h": 2}))
    _, none, _, _ = _pair(PROBLEMS[0], TOPOLOGIES[0], ("periodic", {"h": 2}),
                          compression=("none", {}))
    assert none.compression is None and none.wire_ratio(d) == 1.0
    assert none._kernel() is plain._kernel()
    ours = none.run(torch.zeros((n, d)), 40, eval_every=10)
    assert ours == plain.run(torch.zeros((n, d)), 40, eval_every=10)
    np.testing.assert_array_equal(none.last_res_norms, np.zeros(4))


def test_compress_keep_is_topk():
    _, alias, n, d = _pair(PROBLEMS[0], TOPOLOGIES[0], ("every", {}),
                           compress_keep=0.25)
    _, topk, _, _ = _pair(PROBLEMS[0], TOPOLOGIES[0], ("every", {}),
                          compression=("topk", {"keep": 0.25}))
    assert alias.compression == port_comp.TopK(keep=0.25)
    assert alias.compress_keep == 0.25 and topk.compress_keep is None
    assert alias._kernel().__name__.endswith("compress_mix")
    assert (alias.run(torch.zeros((n, d)), 30, eval_every=10)
            == topk.run(torch.zeros((n, d)), 30, eval_every=10))
    np.testing.assert_array_equal(alias.last_res_norms, topk.last_res_norms)
    alias.run(torch.zeros((n, d)), 30, eval_every=10, loop="segment")
    assert alias.last_res_norms is None  # as the reference's segment loop


@pytest.mark.parametrize("compression", COMPRESSED, ids=COMPRESSED_IDS)
def test_compressed_run_carried_across_from_the_reference(compression):
    """Half a compressed run on the reference, its carry -- a nonzero
    error-feedback residual included -- moved into the port, the other half
    on both sides."""
    ref, port, n, d = _pair(PROBLEMS[0], TOPOLOGIES[0], ("periodic", {"h": 2}),
                            compression=compression)
    T = 40
    mask = np.asarray(ref.schedule.comm_mask(0, T), dtype=bool)
    x0 = jnp.zeros((n, d), jnp.float32)
    root = jax.random.PRNGKey(0)
    carry = ref._segment(jnp.zeros_like(x0), x0, x0, jnp.zeros_like(x0),
                         jnp.float32(0.0), jnp.asarray(mask[:T // 2]),
                         jax.random.split(root, T // 2))
    arrays = dict(zip(("z", "x", "xhat", "res", "t"),
                      (np.asarray(a) for a in carry)))
    assert np.abs(arrays["res"]).max() > 0
    state = state_from_reference(arrays, device="cpu")
    ours = port._segment(*state, mask[T // 2:])
    theirs = ref._segment(*carry, jnp.asarray(mask[T // 2:]),
                          jax.random.split(jax.random.fold_in(root, T // 2),
                                           T // 2))
    assert float(ours[4]) == float(theirs[4]) == float(T)
    res_atol = ATOL
    if compression[0] == "int8":
        res_atol = RTOL * float(np.abs(np.asarray(theirs[0])
                                       + np.asarray(theirs[3])).max())
    for name, a, b in zip(("z", "x", "xhat", "res"), ours, theirs):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=RTOL,
            atol=res_atol if name == "res" else ATOL, err_msg=name)
