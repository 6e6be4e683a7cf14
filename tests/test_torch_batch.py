"""The port's batched lanes (`DDASimulator.run_batch`, the program behind
`run_sweep(parallel="vmap")`) against the reference's vmapped `run_batch`,
on the CPU: the same masks, seeds and rs, uncompressed and under every
compressor, on the sparse and dense mixes. Also the lane semantics the
reference's vmap gives: rand-k and stochastic int8 draw one (n, d) sample
a round that every lane shares, top-k and int8 reduce per (node, lane);
the one-lane program issues `_segment`'s ops (bit for bit), and each lane's
state is its solo run's.

Tolerances: the port's float32 tolerance, rtol 1e-5 and atol 1e-6, on the
traces and residual norms, as tests/test_torch_dda.py holds solo runs;
the int8 residual norms at rtol 1e-4 for the reason given there.
"""

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
from repro_torch.core import schedules as port_sched
from repro_torch.core.dda import DDASimulator as PortSim
from repro_torch.core.dda import stepsize_sqrt as port_stepsize
from repro_torch.experiments import components as port_C

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
INT8_RES_RTOL = 1e-4
N, D, T, EVERY = 8, 12, 60, 20

COMPRESSED = [None, ("topk", {"keep": 0.25}),
              ("randk", {"keep": 0.25, "seed": 1}), ("int8", {}),
              ("int8", {"stochastic": True, "seed": 2})]
COMPRESSED_IDS = ["none", "topk", "randk", "int8", "int8-stochastic"]
MIXES = [(("expander", {"k": 4}), "auto"), (("expander", {"k": 4}), "dense"),
         (("complete", {}), "auto")]
MIX_IDS = ["expander-sparse", "expander-dense", "complete"]
#: three lanes: every iteration, every third, and an increasingly sparse
#: pattern, the paper's three schedules
MASKS = np.stack([port_sched.EveryIteration().comm_mask(0, T),
                  port_sched.Periodic(h=3).comm_mask(0, T),
                  port_sched.IncreasinglySparse(p=0.3).comm_mask(0, T)]
                 ).astype(bool)


def _pair(topology=MIXES[0][0], mix="auto", compression=None):
    ref_kw, port_kw = {}, {}
    if compression is not None:
        ref_kw["compression"] = ref_comp.build_compressor(*compression)
        port_kw["compression"] = port_comp.build_compressor(*compression)
    params = {"n": N, "d": D}
    ref_p = ref_C.build_component(ref_C.problems, "quadratic_consensus",
                                  params)
    port_p = port_C.build_component(port_C.problems, "quadratic_consensus",
                                    params, device=CPU)
    ref = RefSim(ref_p.subgrad_stack, jax.jit(ref_p.objective),
                 ref_C.build_component(ref_C.topologies, *topology, n=N),
                 a_fn=ref_stepsize(0.5), r=0.01, mix=mix, **ref_kw)
    port = PortSim(port_p.subgrad_stack, port_p.objective,
                   port_C.build_component(port_C.topologies, *topology, n=N),
                   a_fn=port_stepsize(0.5), r=0.01, mix=mix, device=CPU,
                   **port_kw)
    return ref, port


@pytest.mark.parametrize("topology,mix", MIXES, ids=MIX_IDS)
@pytest.mark.parametrize("compression", COMPRESSED, ids=COMPRESSED_IDS)
def test_run_batch_matches_reference(compression, topology, mix):
    ref, port = _pair(topology, mix, compression)
    assert port.mix_mode == ref.mix_mode
    seeds, rs = [0, 1, 2], [0.0, 0.01, 0.1]
    theirs = ref.run_batch(jnp.zeros((N, D), jnp.float32), T, EVERY, MASKS,
                           seeds, rs=rs)
    ours = port.run_batch(torch.zeros((N, D)), T, EVERY, MASKS, seeds, rs=rs)
    assert port.last_loop == "eager"  # no capture on the CPU
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.iters == b.iters
        assert a.sim_time == b.sim_time  # r * c per lane, on the host
        assert a.comms == b.comms
        for f in ("fvals", "fvals_consensus", "disagreement"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, atol=ATOL, err_msg=f)
    assert port.last_res_norms.shape == np.asarray(
        ref.last_res_norms).shape == (3, T // EVERY)
    rtol = (INT8_RES_RTOL if compression and compression[0] == "int8"
            else RTOL)
    np.testing.assert_allclose(port.last_res_norms, ref.last_res_norms,
                               rtol=rtol, atol=ATOL)


def _lanes(x: torch.Tensor, fn):
    """fn(lane) for each lane of an (n, B, d) stack, stacked at dim 1."""
    return torch.func.vmap(fn, in_dims=1, out_dims=1)(x)


def _ref_lanes(x: np.ndarray, fn):
    return np.asarray(jax.vmap(fn, in_axes=1, out_axes=1)(jnp.asarray(x)))


def test_randk_lanes_share_one_support_per_round():
    """The reference draws rand-k's scores with a key folded from t, which
    every lane shares, and `uniform(key, corrected.shape)` under vmap sees
    one lane's (n, d): so each round every lane keeps the same support."""
    rng = np.random.default_rng(0)
    corrected = rng.standard_normal((N, 4, 64)).astype(np.float32)
    port, ref = (m.RandK(keep=0.25, seed=3) for m in (port_comp, ref_comp))
    for t in (1.0, 7.0, 300.0):
        tt = torch.tensor(t)
        ours = _lanes(torch.from_numpy(corrected),
                      lambda c: port.support_mask_torch(c, tt)).numpy()
        theirs = _ref_lanes(corrected, lambda c: ref.support_mask_jax(
            c, jnp.float32(t)))
        np.testing.assert_array_equal(ours, theirs)
        solo = port.support_mask_torch(torch.from_numpy(corrected[:, 0]),
                                       tt).numpy()
        for b in range(4):
            np.testing.assert_array_equal(ours[:, b], solo)


def test_stochastic_int8_lanes_share_one_noise_draw():
    """Stochastic int8 draws its rounding noise as rand-k draws its
    scores: one (n, d) draw a round, the same in every lane. Lanes with
    the same message therefore send the same codes."""
    rng = np.random.default_rng(1)
    row = rng.standard_normal((N, 1, 32)).astype(np.float32)
    corrected = np.repeat(row, 3, axis=1) * np.float32(1.0)
    port = port_comp.Int8(stochastic=True, seed=5)
    ref = ref_comp.Int8(stochastic=True, seed=5)
    tt = torch.tensor(11.0)
    ours = _lanes(torch.from_numpy(corrected),
                  lambda c: port.compress_torch(c, tt)).numpy()
    theirs = _ref_lanes(corrected,
                        lambda c: ref.compress_jax(c, jnp.float32(11.0)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)
    solo = port.compress_torch(torch.from_numpy(row[:, 0]), tt).numpy()
    for b in range(3):
        np.testing.assert_array_equal(ours[:, b], solo)


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_deterministic_compressors_reduce_per_node_and_lane(kind):
    """Top-k keeps k entries of each (node, lane) row and int8 scales each
    by its own absmax: a lane's result is the lane's solo result."""
    rng = np.random.default_rng(2)
    corrected = rng.standard_normal((N, 3, 40)).astype(np.float32)
    corrected[:, 1] *= 100.0  # a lane of another magnitude
    port = port_comp.build_compressor(kind, {"keep": 0.25} if kind == "topk"
                                      else {})
    tt = torch.tensor(2.0)
    ours = _lanes(torch.from_numpy(corrected),
                  lambda c: port.compress_torch(c, tt))
    for b in range(3):
        solo = port.compress_torch(torch.from_numpy(corrected[:, b]), tt)
        assert torch.equal(ours[:, b], solo)


def _program_state(sim, B):
    prog = sim._programs[((N, D), torch.float32, B)]
    return prog.z, prog.x, prog.xhat, prog.res, prog.t


@pytest.mark.parametrize("compression", COMPRESSED, ids=COMPRESSED_IDS)
def test_one_lane_program_is_segment_bit_for_bit(compression):
    """loop="scan" (the program at B = 1) and loop="segment" (the same
    program's bodies stepped eagerly, the statistics read after each
    segment) give the same trace and the same final carry, bit for bit;
    `_segment` from the start gives that carry too."""
    _, port = _pair(compression=compression)
    port.schedule = port_sched.Periodic(h=3)
    scan = port.run(torch.zeros((N, D)), T, eval_every=EVERY)
    got = _program_state(port, 1)
    segment = port.run(torch.zeros((N, D)), T, eval_every=EVERY,
                       loop="segment")
    assert segment == scan
    stepped = port._programs[((N, D), torch.float32, 1, "eager")]
    assert stepped is not port._programs[((N, D), torch.float32, 1)]
    z0 = torch.zeros((N, D))
    expect = port._segment(z0, z0, z0, z0, torch.tensor(0.0),
                           np.asarray(port.schedule.comm_mask(0, T), bool))
    for name, a, b, c in zip(("z", "x", "xhat", "res"), got, expect,
                             (stepped.z, stepped.x, stepped.xhat,
                              stepped.res)):
        assert torch.equal(a[:, 0], b), name
        assert torch.equal(c[:, 0], b), name
    assert float(got[4]) == float(expect[4]) == T


@pytest.mark.parametrize("topology,mix", MIXES[:1], ids=MIX_IDS[:1])
@pytest.mark.parametrize("compression", COMPRESSED, ids=COMPRESSED_IDS)
def test_lane_states_are_their_solo_runs(compression, topology, mix):
    """On the sparse mix every column mixes on its own and the
    problem's subgradient is elementwise, so each lane's final carry is its
    solo `_segment` run's, bit for bit; a lane that does not communicate at
    an iteration keeps its z and residual."""
    _, port = _pair(topology, mix, compression)
    port.run_batch(torch.zeros((N, D)), T, EVERY, MASKS, [0, 0, 0])
    got = _program_state(port, 3)
    z0 = torch.zeros((N, D))
    for b in range(3):
        solo = port._segment(z0, z0, z0, z0, torch.tensor(0.0), MASKS[b])
        for name, a, e in zip(("z", "x", "xhat", "res"), got, solo):
            assert torch.equal(a[:, b], e), (b, name)


def test_run_batch_checks_its_inputs():
    _, port = _pair()
    x0 = torch.zeros((N, D))
    with pytest.raises(ValueError, match="masks"):
        port.run_batch(x0, T, EVERY, MASKS[:, :10], [0, 1, 2])
    with pytest.raises(ValueError, match="seeds"):
        port.run_batch(x0, T, EVERY, MASKS, [0, 1])
    with pytest.raises(ValueError, match="rs"):
        port.run_batch(x0, T, EVERY, MASKS, [0, 1, 2], rs=[0.1])
    with pytest.raises(ValueError, match="stacked"):
        port.run_batch(torch.zeros((N + 1, D)), T, EVERY, MASKS, [0, 1, 2])
    empty = port.run_batch(x0, 0, EVERY, np.zeros((2, 0), bool), [0, 1])
    assert [t.iters for t in empty] == [[], []]


def test_programs_are_built_once_per_shape():
    """A simulator keeps its run programs by (x0 shape, dtype, lanes): a
    second run, another run length or another schedule reuses the one
    program (on a card, its captured graphs); a batch is a program of its
    own, rebuilt only for a longer mask than its flag buffer holds."""
    _, port = _pair()
    x0 = torch.zeros((N, D))
    port.run(x0, T, eval_every=EVERY)
    (key, prog), = port._programs.items()
    port.schedule = port_sched.Periodic(h=5)
    port.run(x0, 2 * T, eval_every=EVERY)
    assert port._programs == {key: prog}
    port.run_batch(x0, T, EVERY, MASKS, [0, 1, 2])
    batch = port._programs[((N, D), torch.float32, 3)]
    port.run_batch(x0, T // 2, EVERY, MASKS[:, :T // 2], [0, 1, 2])
    assert port._programs[((N, D), torch.float32, 3)] is batch
    longer = np.concatenate([MASKS, MASKS], axis=1)
    port.run_batch(x0, 2 * T, EVERY, longer, [0, 1, 2])
    assert port._programs[((N, D), torch.float32, 3)] is not batch
    assert port._programs[key] is prog
