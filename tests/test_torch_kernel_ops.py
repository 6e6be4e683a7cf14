"""The kernel library's front doors, K3 to K6: `repro_torch.kernels.ops`'s
`gossip_mix`, `flash_attention`, `selective_scan` and `ssd_scan` against
`repro.kernels.ops`, and their plain versions against `repro.kernels.ref`.
The CUDA kernels themselves are tested on the card by
tests/test_torch_kernels_card.py.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
  - plain version against the jnp oracle (jitted), float32: rtol 1e-5,
    atol 1e-6 (the same algorithm; XLA may reorder a sum or contract a
    multiply-add into an FMA);
  - front door on the CPU against the reference's Pallas kernel run in
    interpret mode: tests/test_kernels.py's tolerances (flash float32 atol
    2e-5 / rtol 2e-4, bfloat16 atol 2e-2 / rtol 2e-1; the scans atol 5e-4 /
    rtol 2e-3, since the reference's SSD kernel is the chunked form and the
    port's plain version the sequential one; the flat mix 1e-5).
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref

from repro_torch.kernels import (build, flash_attention, gossip_mix, ops, ref,
                                 selective_scan, ssd_scan)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE_TOL = dict(rtol=1e-5, atol=1e-6)
SCAN_TOL = dict(atol=5e-4, rtol=2e-3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _attention_inputs(B, H, KH, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, KH, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, KH, Sk, D)).astype(np.float32)
    return q, k, v


def _softplus(a):
    return np.log1p(np.exp(a))


def _mamba1_inputs(Bt, S, d, N, seed):
    """tests/test_kernels.py's distributions for the selective scan."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(Bt, S, d)) * 0.5).astype(np.float32)
    dt = _softplus(rng.normal(size=(Bt, S, d)) - 1.0).astype(np.float32)
    A = (-np.exp(rng.normal(size=(d, N)) * 0.3)).astype(np.float32)
    B = (rng.normal(size=(Bt, S, N)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(Bt, S, N)) * 0.5).astype(np.float32)
    D_skip = np.ones((d,), np.float32)
    return x, dt, A, B, C, D_skip


def _mamba2_inputs(Bt, S, H, P, N, seed):
    """tests/test_kernels.py's distributions for the SSD scan."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(Bt, S, H, P)) * 0.5).astype(np.float32)
    dt = _softplus(rng.normal(size=(Bt, S, H)) - 1.0).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    B = (rng.normal(size=(Bt, S, N)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(Bt, S, N)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


# ---------------------------------------------------------------------------
# plain versions against the reference's jnp oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,D,H,KH", [(128, 64, 4, 4), (256, 64, 8, 2),
                                      (256, 128, 4, 1), (512, 32, 2, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_the_oracle(S, D, H, KH, causal):
    """tests/test_kernels.py's shapes, at Sq == Sk, where the reference's
    bottom-right oracle and the top-left kernel agree."""
    q, k, v = _attention_inputs(2, H, KH, S, S, D, seed=S + D + H + KH)
    ours = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    oracle = jax.jit(jref.flash_attention_ref, static_argnames="causal")(
        q, k, v, causal=causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle),
                               **ORACLE_TOL)


@pytest.mark.parametrize("S,d,N", [(256, 128, 8), (512, 256, 16),
                                   (256, 512, 16)])
def test_plain_selective_scan_matches_the_oracle(S, d, N):
    args = _mamba1_inputs(2, S, d, N, seed=S + d + N)
    ours = ref.selective_scan_ref(*map(_t, args))
    oracle = jax.jit(jref.selective_scan_ref)(*args)
    assert ours.dtype == torch.float32 and ours.shape == (2, S, d)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle),
                               **ORACLE_TOL)


@pytest.mark.parametrize("S,H,P,N", [(256, 4, 32, 16), (512, 2, 64, 64),
                                     (128, 8, 64, 32)])
def test_plain_ssd_scan_matches_the_oracle(S, H, P, N):
    args = _mamba2_inputs(2, S, H, P, N, seed=S + H + P + N)
    ours = ref.ssd_scan_ref(*map(_t, args))
    oracle = jax.jit(jref.ssd_scan_ref)(*args)
    assert ours.dtype == torch.float32 and ours.shape == (2, S, H, P)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle),
                               **ORACLE_TOL)


@pytest.mark.parametrize("M,k", [(1, 1), (1000, 4), (8193, 6), (50000, 3)])
def test_plain_flat_mix_matches_the_oracle(M, k):
    rng = np.random.default_rng(M + k)
    sb = rng.normal(size=(M,)).astype(np.float32)
    nb = rng.normal(size=(k, M)).astype(np.float32)
    sw = float(rng.uniform(0.05, 0.9))
    ew = (1.0 - sw) / k
    ours = ref.gossip_mix_ref(_t(sb), _t(nb), sw, ew)
    oracle = jax.jit(jref.gossip_mix_ref, static_argnums=(2, 3))(sb, nb, sw,
                                                                 ew)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle),
                               **ORACLE_TOL)


# ---------------------------------------------------------------------------
# front doors on the CPU against the reference's Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def test_causal_mask_is_top_left_as_the_tpu_kernel():
    """Sq=128, Sk=256, causal: the port's front door computes what the TPU
    kernel and the reference's front door compute (query row r sees key
    columns c <= r), and the reference's own oracle, which aligns the mask
    bottom-right, does not (ROADMAP queue 3)."""
    q, k, v = _attention_inputs(1, 2, 1, 128, 256, 64, seed=0)
    ours = ops.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    pallas = np.asarray(ref_ops.flash_attention(q, k, v, causal=True,
                                                interpret=True))
    np.testing.assert_allclose(ours, pallas, atol=2e-5, rtol=2e-4)
    # the same top-left rule as torch's own causal attention
    torch_sdpa = torch.nn.functional.scaled_dot_product_attention(
        _t(q), _t(k).repeat_interleave(2, dim=1),
        _t(v).repeat_interleave(2, dim=1), is_causal=True).numpy()
    np.testing.assert_allclose(ours, torch_sdpa, atol=2e-5, rtol=2e-4)
    bottom_right = np.asarray(jref.flash_attention_ref(q, k, v, causal=True))
    assert np.abs(bottom_right - pallas).max() > 1.0


@pytest.mark.parametrize("case", [
    dict(B=1, H=2, KH=2, Sq=128, Sk=256, D=64, causal=False,
         dtype="float32"),
    dict(B=2, H=4, KH=2, Sq=128, Sk=128, D=32, causal=True,
         dtype="bfloat16"),
], ids=["non-causal-Sq<Sk", "gqa-bf16"])
def test_attention_front_door_matches_the_pallas_kernel(case):
    q, k, v = _attention_inputs(case["B"], case["H"], case["KH"], case["Sq"],
                                case["Sk"], case["D"], seed=7)
    tdtype = getattr(torch, case["dtype"])
    jdtype = getattr(jnp, case["dtype"])
    ours = ops.flash_attention(_t(q).to(tdtype), _t(k).to(tdtype),
                               _t(v).to(tdtype), causal=case["causal"])
    pallas = ref_ops.flash_attention(
        jnp.asarray(q, jdtype), jnp.asarray(k, jdtype), jnp.asarray(v, jdtype),
        causal=case["causal"], interpret=True)
    assert ours.dtype == tdtype and tuple(ours.shape) == pallas.shape
    atol = 2e-5 if case["dtype"] == "float32" else 2e-2
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=atol, rtol=atol * 10)


def test_selective_scan_front_door_matches_the_pallas_kernel():
    args = _mamba1_inputs(1, 256, 128, 8, seed=11)
    ours = ops.selective_scan(*map(_t, args))
    pallas = ref_ops.selective_scan(*args, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), **SCAN_TOL)


def test_ssd_scan_front_door_matches_the_pallas_kernel():
    """Two chunks of the reference's kernel (S=256, its chunk 128), so the
    state it carries across chunks is compared too."""
    args = _mamba2_inputs(1, 256, 2, 32, 16, seed=13)
    ours = ops.ssd_scan(*map(_t, args))
    pallas = ref_ops.ssd_scan(*args, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), **SCAN_TOL)


def test_ssd_scan_front_door_matches_the_model_mixer():
    """The port's SSD front door agrees with the reference model's chunked
    XLA mixer (`repro.models.ssm._ssd_chunk`), at zamba2-2.7b's smoke
    widths, as tests/test_kernels.py holds the Pallas kernel to it."""
    from repro.models import get_config
    from repro.models import ssm as ssm_mod

    cfg = get_config("zamba2-2.7b", "smoke")
    _, nheads = ssm_mod._m2_dims(cfg)
    x, dt, A, B, C = _mamba2_inputs(2, 64, nheads, cfg.ssm_head_dim,
                                    cfg.ssm_state, seed=17)
    ours = ops.ssd_scan(*map(_t, (x, dt, A, B, C)))
    h0 = jnp.zeros((2, nheads, cfg.ssm_head_dim, cfg.ssm_state))
    _, model = ssm_mod._ssd_chunk(h0, x, dt, B, C, A)
    np.testing.assert_allclose(ours.numpy(), np.asarray(model), **SCAN_TOL)


@pytest.mark.parametrize("M,k,dtype", [(1000, 3, "float32"),
                                       (8195, 4, "float32"),
                                       (4099, 2, "bfloat16")])
def test_flat_mix_front_door_matches_the_pallas_kernel(M, k, dtype):
    """M not a multiple of the reference's (8, 1024) tile: it pads, the
    port does not."""
    rng = np.random.default_rng(M)
    sb = rng.normal(size=(M,)).astype(np.float32)
    nb = rng.normal(size=(k, M)).astype(np.float32)
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    ours = ops.gossip_mix(_t(sb).to(tdtype), _t(nb).to(tdtype), 0.2, 0.8 / k)
    pallas = ref_ops.gossip_mix(jnp.asarray(sb, jdtype),
                                jnp.asarray(nb, jdtype), 0.2, 0.8 / k,
                                interpret=True)
    assert ours.dtype == tdtype and tuple(ours.shape) == (M,)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# refusals and dispatch
# ---------------------------------------------------------------------------


def _attention_call(pkg, B=1, H=2, KH=1, Sq=128, Sk=128, D=32):
    q, k, v = _attention_inputs(B, H, KH, Sq, Sk, D, seed=1)
    if pkg == "port":
        return ops.flash_attention(_t(q), _t(k), _t(v))
    return ref_ops.flash_attention(q, k, v, interpret=True)


def _selective_call(pkg, S=256, d=128):
    args = _mamba1_inputs(1, S, d, 4, seed=2)
    if pkg == "port":
        return ops.selective_scan(*map(_t, args))
    return ref_ops.selective_scan(*args, interpret=True)


def _ssd_call(pkg, S=128):
    args = _mamba2_inputs(1, S, 2, 8, 4, seed=3)
    if pkg == "port":
        return ops.ssd_scan(*map(_t, args))
    return ref_ops.ssd_scan(*args, interpret=True)


def _flat_call(pkg, M=64, nbr_M=64):
    sb = np.ones((M,), np.float32)
    nb = np.ones((2, nbr_M), np.float32)
    if pkg == "port":
        return ops.gossip_mix(_t(sb), _t(nb), 0.5, 0.25)
    return ref_ops.gossip_mix(sb, nb, 0.5, 0.25, interpret=True)


@pytest.mark.parametrize("call,kwargs,match", [
    (_attention_call, dict(Sq=200, Sk=200), "Sq=200"),
    (_attention_call, dict(Sk=384 + 64), "Sk=448"),
    (_attention_call, dict(H=3, KH=2), "KH=2"),
    (_selective_call, dict(S=300), "S=300"),
    (_selective_call, dict(d=640), "d=640"),
    (_ssd_call, dict(S=192), "S=192"),
    (_flat_call, dict(nbr_M=65), r"\(k, 64\)"),
], ids=["flash-Sq", "flash-Sk", "flash-H%KH", "sscan-S", "sscan-d", "ssd-S",
        "flat-M"])
def test_front_doors_refuse_what_the_reference_refuses(call, kwargs, match):
    with pytest.raises(Exception):
        call("reference", **kwargs)
    with pytest.raises(ValueError, match=match):
        call("port", **kwargs)


def test_cpu_tensors_reach_the_plain_versions_and_launch_nothing():
    counts = (gossip_mix.FLAT_LAUNCHES, flash_attention.LAUNCHES,
              selective_scan.LAUNCHES, ssd_scan.LAUNCHES)
    outs = [_flat_call("port"), _attention_call("port"),
            _selective_call("port"), _ssd_call("port")]
    assert all(o.device.type == "cpu" for o in outs)
    assert (gossip_mix.FLAT_LAUNCHES, flash_attention.LAUNCHES,
            selective_scan.LAUNCHES, ssd_scan.LAUNCHES) == counts


@pytest.mark.parametrize("call", [
    lambda t: gossip_mix.gossip_mix(t, t[None], 0.5, 0.5),
    lambda t: flash_attention.flash_attention(*(t.reshape(1, 1, 4, 2),) * 3),
    lambda t: selective_scan.selective_scan(
        t.reshape(1, 4, 2), t.reshape(1, 4, 2), t.reshape(2, 4),
        t.reshape(1, 2, 4), t.reshape(1, 2, 4), t[:2]),
    lambda t: ssd_scan.ssd_scan(t.reshape(1, 4, 1, 2), t.reshape(1, 4, 2),
                                t[:1], t.reshape(1, 4, 2), t.reshape(1, 4, 2)),
], ids=["K3", "K4", "K6", "K5"])
def test_wrappers_take_cuda_tensors_only(call):
    """The wrappers launch or raise; the CPU goes through kernels.ops."""
    with pytest.raises(ValueError, match="CUDA tensors only"):
        call(torch.ones(8))


def test_every_source_names_the_pallas_function_it_replaces():
    """Each CUDA source of the port is built by build.py and names, by file
    and line, the Pallas function it replaces; the line holds that `def`."""
    sources = sorted(p.stem for p in (build.CSRC).glob("*.cu"))
    assert sorted(build.SOURCES) == sources
    cited = set()
    for name in sources:
        text = (build.CSRC / f"{name}.cu").read_text()
        refs = re.findall(r"`(\w+)` \(src/repro/kernels/\s*(?://\s*)?"
                          r"(\w+\.py):(\d+)", text)
        assert refs, f"{name}.cu names no Pallas function it replaces"
        for fn, path, line in refs:
            lines = (ROOT / "src" / "repro" / "kernels" / path).read_text() \
                .splitlines()
            assert lines[int(line) - 1].startswith(f"def {fn}("), (
                name, fn, path, line)
            cited.add(fn)
    assert {"gossip_mix", "gossip_mix_weighted", "compress_mix_weighted",
            "flash_attention", "ssd_scan", "selective_scan"} <= cited


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 8, "sm90"), (torch.bfloat16, 16, "sm90"),
    (torch.bfloat16, 48, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 80, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 160, "sm90"), (torch.bfloat16, 256, "sm90"),
    (torch.bfloat16, 12, "tf32x3"), (torch.bfloat16, 100, "tf32x3"),
    (torch.bfloat16, 1, "tf32x3"), (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"), (torch.float32, 12, "tf32x3"),
])
def test_attention_route_rule(dtype, D, want):
    """bf16 with D a multiple of 8 (16-byte TMA rows) goes to the sm90
    kernel; fp32 (its tolerance is beyond single-pass TF32, so three
    passes) and any other D to the 3xTF32 kernel. Each route names a source
    that build.py builds."""
    assert flash_attention.route(dtype, D) == want
    stem, entries = flash_attention.ROUTES[want]
    assert stem in build.SOURCES and dtype in entries


def test_attention_wrapper_imports_and_routes_without_cuda():
    """The wrapper module imports, and routes, on a machine with no card:
    nothing is built or loaded at import."""
    code = ("import torch\n"
            "from repro_torch.kernels import build, flash_attention as fa\n"
            "assert not torch.cuda.is_available()\n"
            "assert fa.route(torch.bfloat16, 128) == 'sm90'\n"
            "assert fa.SM90_LAUNCHES == fa.TF32X3_LAUNCHES == 0\n"
            "assert not build._LOADED\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 12)])
def test_fp32_out_entry_takes_only_the_sm90_route(dtype, D):
    t = torch.ones((1, 1, 4, D), dtype=dtype)
    with pytest.raises(ValueError, match="fp32-out entry takes bf16"):
        flash_attention._flash_attention_fp32_out(t, t, t)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention._flash_attention_fp32_out(*(t.bfloat16()[..., :8],)
                                                  * 3)
