"""What the sharded step holds, on the reference's terms, on the CPU: the
streamed attention's chunks rematerialized, a rank's own query rows where
the kv heads do not divide the model axis, and the loss's log-sum-exp on
vocab shards.

  * (a) `_sdpa_causal_streamed` at T = 2048 (two KV chunks) and
    `_cross_softmax` over N = 3200 encoder keys (two chunks) keep no
    tensor of a chunk's scores for the backward (counted by
    `torch.autograd.graph.saved_tensors_hooks`; the unwrapped loop, each
    chunk body called as it is, keeps them); their outputs and gradients
    equal the unwrapped loop's bit for bit. Against the reference's
    `jax.vjp` on the same numpy inputs, each to its largest magnitude in
    float32: the causal form against
    `repro.models.attention._sdpa_causal_streamed` within `REF_TOL` =
    2e-6 (observed at most 6.0e-7); `cross_attn_apply`, which runs
    `_cross_softmax`, within the cross-attention's standards
    (`tests/test_torch_cross_attn.py`): `CROSS_TOL` = 1e-5 (observed at
    most 1.8e-6) and, for the encoder's gradient, `ENC_TOL` = 5e-5
    (observed 5.7e-6).
  * (b) on two gloo ranks at (data 1, model 2) with one kv head, the
    causal attention (streamed at S = T = 2048, whole at 16) and the
    cross softmax run each rank's S/2 query rows, the output keeps q's
    sequence shard, no all-gather takes q, and the output and the
    gradients of q, k and v lie within `SHARDED_TOL` = 1e-5 of the
    one-device functions' largest magnitude (observed: the output and
    q's gradient 0, k's and v's, sums over the two ranks' rows, at most
    2.2e-7; 1.8e-6 where the one-device functions run on several
    threads).
  * (c) `cross_entropy_loss` on vocab-sharded logits issues no all-gather
    over a placeholder group of (data 2, model 4) on meta tensors; on the
    two gloo ranks its value and gradient lie within `LOSS_TOL` = 1e-6 of
    the plain loss (observed 0 and 2.2e-7), the gradient on the rank's
    vocab shard; on one rank they equal the plain loss's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models.common import split_axes

from repro_torch.launch import dryrun as port_dryrun
from repro_torch.models import attention as port_attn
from repro_torch.models.common import cross_entropy_loss

import _ranks
from _decode import one_torch_thread  # noqa: F401 (autouse)
from _decode import carry, configs, perturbed, rel

VISION = "llama-3.2-vision-90b"

#: outputs and gradients against the reference's, to their largest
#: magnitude (module docstring)
REF_TOL = 2e-6
#: `cross_attn_apply` against the reference's, and its encoder's gradient
CROSS_TOL, ENC_TOL = 1e-5, 5e-5
#: the two-rank attention against the one-device functions
SHARDED_TOL = 1e-5
#: the two-rank loss against the plain loss
LOSS_TOL = 1e-6

#: the causal case: two KV chunks, 4 heads over 2 kv heads
B, S, H, K, HD = 1, 2048, 4, 2, 16
#: the cross-attention case: S query rows over N encoder tokens
CROSS_S, CROSS_N = 16, 3200


def _normal(rng, *shapes) -> list:
    return [rng.normal(size=shape).astype(np.float32) for shape in shapes]


def _rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _unwrapped(monkeypatch):
    """Each chunk body called as it is, not checkpointed."""
    monkeypatch.setattr(port_attn, "_chunked", lambda body, *args:
                        body(*args))


def _run_counted(fn, inputs, g, chunk_numel: int) -> tuple:
    """fn(*inputs)'s output and its inputs' gradients for the cotangent
    g, and how many of the tensors the forward saves for the backward hold
    at least a chunk's scores (`chunk_numel` elements)."""
    big = []

    def pack(t):
        if t.numel() >= chunk_numel:
            big.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*inputs)
    grads = torch.autograd.grad(out, inputs, g)
    return out.detach(), grads, big


def _causal_inputs():
    q, k, v, g = _normal(np.random.default_rng(31), (B, S, H, HD),
                         (B, S, K, HD), (B, S, K, HD), (B, S, H, HD))
    return (q, k, v), g


def test_streamed_chunks_keep_no_scores_for_the_backward(monkeypatch):
    """(a) The causal stream: no saved tensor of a chunk's (B, S, K, G,
    1024) scores, the unwrapped loop's bits, the reference's values."""
    (q, k, v), g = _causal_inputs()
    chunk = B * S * H * port_attn._KV_CHUNK
    assert S == 2 * port_attn._KV_CHUNK

    def run():
        qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        return _run_counted(port_attn._sdpa_causal_streamed, qkv,
                            torch.from_numpy(g), chunk)
    out, grads, big = run()
    assert big == []
    with monkeypatch.context() as m:
        _unwrapped(m)
        out_u, grads_u, big_u = run()
    assert len(big_u) >= 2  # the count sees what the unwrapped loop keeps
    for a, b in zip((out, *grads), (out_u, *grads_u)):
        assert torch.equal(a, b)
    out_r, vjp = jax.vjp(ref_attn._sdpa_causal_streamed,
                         *(jnp.asarray(a) for a in (q, k, v)))
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (out_r, *vjp(jnp.asarray(g)))):
        assert _rel(a.numpy(), b) <= REF_TOL, name


def test_cross_chunks_keep_no_scores_for_the_backward(monkeypatch):
    """(a) The cross-attention's stream: `_cross_softmax` saves no
    (B, S, K, G, 1600) chunk of scores and keeps the unwrapped loop's
    bits; `cross_attn_apply`, which runs it, lies within the reference's
    float32 standards in its output and every gradient (CROSS_TOL; the
    encoder's, summed over 3200 keys with cancellation, ENC_TOL)."""
    rng = np.random.default_rng(32)
    q, k, v, g = _normal(rng, (B, CROSS_S, H, HD), (B, CROSS_N, K, HD),
                         (B, CROSS_N, K, HD), (B, CROSS_S, H, HD))
    chunk = B * CROSS_S * H * port_attn._ENC_CHUNK
    assert CROSS_N == 2 * port_attn._ENC_CHUNK

    def run():
        qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        return _run_counted(
            lambda *t: port_attn._cross_softmax(*t, torch.float32), qkv,
            torch.from_numpy(g), chunk)
    out, grads, big = run()
    assert big == []
    with monkeypatch.context() as m:
        _unwrapped(m)
        out_u, grads_u, big_u = run()
    assert len(big_u) >= 2
    for a, b in zip((out, *grads), (out_u, *grads_u)):
        assert torch.equal(a, b)

    cfg_r, cfg_t = configs(VISION, jnp.float32, torch.float32,
                           num_encoder_tokens=CROSS_N, encoder_dim=8)
    prm = perturbed(split_axes(ref_attn.cross_attn_init(
        jax.random.PRNGKey(3), cfg_r))[0], 3)
    x, enc, cot = _normal(rng, (B, CROSS_S, cfg_r.d_model), (B, CROSS_N, 8),
                          (B, CROSS_S, cfg_r.d_model))
    out_r, vjp = jax.vjp(lambda a, b, c: ref_attn.cross_attn_apply(
        a, b, c, cfg_r), prm, jnp.asarray(x), jnp.asarray(enc))
    g_prm, g_x, g_enc = vjp(jnp.asarray(cot))
    prm_t = carry(prm)
    names = sorted(prm_t)
    leaves = [prm_t[n].requires_grad_() for n in names]
    x_t, enc_t = (torch.from_numpy(a).requires_grad_() for a in (x, enc))
    out_t = port_attn.cross_attn_apply(prm_t, x_t, enc_t, cfg_t)
    got = torch.autograd.grad(out_t, leaves + [x_t, enc_t],
                              torch.from_numpy(cot))
    errs = {"out": rel(out_r, out_t), "x": rel(g_x, got[-2])}
    errs.update({n: rel(g_prm[n], t) for n, t in zip(names, got)})
    assert rel(g_enc, got[-1]) <= ENC_TOL
    assert max(errs.values()) <= CROSS_TOL, errs


def _attention_payload() -> dict:
    rng = np.random.default_rng(33)
    cases = {}
    for name, kind, s, t in (("streamed", "causal", 2048, 2048),
                             ("whole", "causal", 16, 16),
                             ("cross", "cross", CROSS_S, CROSS_N)):
        q, k, v, g = _normal(rng, (B, s, H, HD), (B, t, 1, HD),
                             (B, t, 1, HD), (B, s, H, HD))
        cases[name] = {"kind": kind, "q": q, "k": k, "v": v, "g": g}
    return cases


def _loss_payload() -> dict:
    rng = np.random.default_rng(34)
    logits = rng.normal(size=(2, 4, 16)).astype(np.float32) * 3.0
    labels = rng.integers(0, 16, size=(2, 4)).astype(np.int64)
    labels[0, 1] = labels[1, 3] = -1
    return {"logits": logits, "labels": labels}


def _plain_loss(case: dict) -> tuple:
    logits = torch.from_numpy(case["logits"]).requires_grad_()
    loss = cross_entropy_loss(logits, torch.from_numpy(case["labels"]))
    grad, = torch.autograd.grad(loss, logits)
    return loss.detach(), grad


def test_sharded_rows_and_loss_on_two_ranks():
    """(b) and (c) on two gloo ranks at (data 1, model 2)."""
    payload = {"attention": _attention_payload(), "loss": _loss_payload()}
    ranks = _ranks.spawn(_ranks.attention_rows, 2, payload)
    for rank, res in enumerate(ranks):
        for name, got in res["attention"].items():
            case = payload["attention"][name]
            s = case["q"].shape[1]
            assert got["rows"] and set(got["rows"]) == {s // 2}, name
            assert got["placements"] == ["R", "S1"], name
            assert [B, s // 2, H, HD] not in got["gathered"], name
            qkv = [torch.from_numpy(case[n]).requires_grad_() for n in "qkv"]
            if case["kind"] == "causal":
                out = port_attn._sdpa_causal(*qkv)
            else:
                out = port_attn._cross_softmax(*qkv, torch.float32)
            want = [out.detach(), *torch.autograd.grad(
                out, qkv, torch.from_numpy(case["g"]))]
            for what, a, b in zip(("out", "dq", "dk", "dv"),
                                  [got["out"], *got["grads"]], want):
                assert _rel(a, b.numpy()) <= SHARDED_TOL, (name, what, rank)
        loss, grad = _plain_loss(payload["loss"])
        got = res["loss"]
        assert _rel(got["loss"], loss.numpy()) <= LOSS_TOL, rank
        assert _rel(got["grad"], grad.numpy()) <= LOSS_TOL, rank
        assert got["grad_placements"] == ["R", "S2"]


def test_loss_on_one_rank_is_the_plain_loss_bit_for_bit():
    """(c) On a one-rank mesh the loss takes `torch.logsumexp` of the
    local logits: the plain loss and its gradient, bit for bit."""
    payload = {"loss": _loss_payload()}
    got, = _ranks.spawn(_ranks.attention_rows, 1, payload)
    loss, grad = _plain_loss(payload["loss"])
    assert np.array_equal(got["loss"]["loss"], loss.numpy())
    assert np.array_equal(got["loss"]["grad"], grad.numpy())


def test_sharded_loss_gathers_no_logits():
    """(c) Logits (B, S, V) with rows over 'data' 2 and vocab over
    'model' 4, on meta tensors over a placeholder group: the loss and its
    gradient issue all-reduces of (B/2, S) rows' maxima, sums and gold
    logits, and no all-gather."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    Bl, Sl, V = 4, 8, 64
    with port_dryrun.placeholder_group(8):
        dm = DeviceMesh("cuda", torch.arange(8).reshape(2, 4),
                        mesh_dim_names=("data", "model"))
        logits = DTensor.from_local(
            torch.empty(Bl // 2, Sl, V // 4, device="meta"), dm,
            [Shard(0), Shard(2)], run_check=False, shape=(Bl, Sl, V),
            stride=(Sl * V, V, 1)).requires_grad_()
        labels = DTensor.from_local(
            torch.empty(Bl // 2, Sl, dtype=torch.int32, device="meta"), dm,
            [Shard(0), Replicate()], run_check=False, shape=(Bl, Sl),
            stride=(Sl, 1))
        counted = port_dryrun.CollectiveBytes()
        with counted:
            grad, = torch.autograd.grad(cross_entropy_loss(logits, labels),
                                        logits)
        assert tuple(grad.placements) == (Shard(0), Shard(2))
    assert "all-gather" not in counted.calls, counted.gathered
    assert counted.calls.get("all-reduce", 0) >= 2
    assert counted.bytes["all-reduce"] < Bl * Sl * V * 4
