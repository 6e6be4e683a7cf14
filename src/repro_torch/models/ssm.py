"""State-space blocks, the port of `repro.models.ssm`:
Mamba-1 (the selective scan; `mamba1_init`, `_m1_scan_chunk`,
`mamba1_mix`, `mamba1_apply`) and Mamba-2 (SSD; `mamba2_init`,
`_ssd_chunk`, `mamba2_mix`, `mamba2_apply`), with the depthwise causal
conv both run (`_causal_conv`).

The mixers run CHUNKED along the sequence, as the reference's: a loop over
`_CHUNK`-token chunks carries the recurrent state from one to the next, and
with `cfg.remat` each chunk is checkpointed (inside the layer's own
checkpoint), so the backward pass keeps one chunk's intermediates at a
time. When the sequence is not a multiple of the chunk, the whole sequence
is one chunk, as in the reference. Mamba-1's recurrence inside a chunk is a
sequential loop over its tokens (the reference's `lax.scan`); Mamba-2's is
the SSD matmul form. These are plain torch ops under autograd, as the
reference runs its mixers in XLA: the models call neither K5
(`kernels/ssd_scan.py`) nor K6 (`kernels/selective_scan.py`), which have
no backward. On a sharded replica Mamba-1's chunks run on each rank's own
rows and channels (`_m1_scan_local`), not token by token as DTensors, and
Mamba-2's on its rows and heads (`_ssd_local`); the conv runs on each
rank's rows and channels (`_conv_local`) and the projections on local
shards (`runtime.sharding.project`).

Rounding follows the reference's casts: the conv in the activations'
dtype, one tap at a time; `dt` through softplus in float32; the scans in
float32; the output cast back before the gate. `softplus` is jax's
`logaddexp(x, 0)`. The init draws the reference's
bits (jax's threefry through `prng`), and builds Mamba-2's `A` with
`jnp.linspace`'s float32 arithmetic under jit, as the reference's jitted
init computes it; its `log` is correctly rounded here, where XLA's is
not quite (a few elements 1 ulp off at zamba2's 80 heads: pinned in
tests/test_torch_ssm.py).

The one-token decode (`mamba1_decode`, `mamba2_decode`, with
`mamba1_init_cache`, `mamba2_init_cache`) updates the recurrent state
`h` (float32) and the conv window (`_conv_step`) in place, in the cache's
tensors, and returns them. `_conv_step` is the reference's einsum over the
K taps: a float32 sum rounded once to the activations' dtype, which is
not `_causal_conv`'s tap-by-tap rounding (the reference's decode and
forward round the conv differently too). A DTensor cache (its channels
over 'model' under the rules) is stepped and written on each rank's own
channels and heads (`_conv_step_sharded`, `_write_state`), never
gathered.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.compress import prng
from repro_torch import resolve_device_or_meta
from repro_torch.models.common import ModelConfig, leaf_block, p, pz, rms_norm
from repro_torch.runtime.sharding import constrain, is_dtensor, project

PyTree = Any

_CHUNK = 256


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C); w: (C,K); b: (C,). Each tap is
    added in x's dtype, in the reference's order. DTensors run on local
    shards (`_conv_local`)."""
    if is_dtensor(x):
        return _conv_local(x, w, b)
    K = w.shape[1]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k:k + S, :] * w[:, k]
    return out + b


def _conv_local(x, w, b):
    """`_causal_conv` of DTensors on each rank's own rows and channels
    (`local_map`): the depthwise conv is elementwise over batch and
    channels and pads the sequence alone, so x is taken whole along its
    sequence (and sliced to the taps' channel shards where it lies whole
    over them), the taps and bias to x's channels. Gradients: the taps'
    and the bias's a partial sum over the mesh dims that shard x's
    rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    xp = tuple(pl if pl.is_shard(0) or pl.is_shard(2) else
               Shard(2) if wp.is_shard(0) else Replicate()
               for pl, wp in zip(x.placements, w.placements))
    wl = tuple(Shard(0) if pl.is_shard(2) else Replicate() for pl in xp)
    w_grad = tuple(Partial() if pl.is_shard(0) else q
                   for pl, q in zip(xp, wl))
    return local_map(_causal_conv, out_placements=(xp,),
                     in_placements=(xp, wl, wl),
                     in_grad_placements=(xp, w_grad, w_grad),
                     device_mesh=mesh)(x.redistribute(mesh, xp),
                                       w.redistribute(mesh, wl),
                                       b.redistribute(mesh, wl))


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor,
               w: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token causal conv. x_t: (B,C); conv_state: (B,K-1,C). The
    window's taps are summed in float32 and rounded once to the window's
    (promoted) dtype, as the reference's einsum; returns (out, the next
    window (B,K-1,C))."""
    if is_dtensor(conv_state):
        return _conv_step_sharded(x_t, conv_state, w, b)
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B,K,C)
    dt = torch.promote_types(window.dtype, w.dtype)
    out = torch.einsum("bkc,ck->bc", window.float(), w.float()).to(dt) + b
    return out, window[:, 1:, :]


def _conv_step_sharded(x_t, conv_state, w, b):
    """`_conv_step` of a DTensor window on each rank's own rows and
    channels (the rules put the channels over 'model'): the token, taps
    and bias taken to the window's channels, the window never gathered.
    Returns (out, the next window), DTensors in the window's layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = conv_state.device_mesh
    st = tuple(conv_state.placements)                  # (B, K-1, C)
    tok = tuple(Shard(1) if pl.is_shard(2) else pl for pl in st)
    chan = tuple(Shard(0) if pl.is_shard(2) else Replicate() for pl in st)
    out, window = _conv_step(x_t.redistribute(mesh, tok).to_local(),
                             conv_state.to_local(),
                             w.redistribute(mesh, chan).to_local(),
                             b.redistribute(mesh, chan).to_local())
    B, K1, C = conv_state.shape
    return (DTensor.from_local(out, mesh, tok, run_check=False,
                               shape=(B, C), stride=(C, 1)),
            DTensor.from_local(window.contiguous(), mesh, st,
                               run_check=False, shape=(B, K1, C),
                               stride=(K1 * C, C, 1)))


def _write_state(buf, value) -> None:
    """A decode's new recurrent state `value` into the cache's `buf`, in
    place: a DTensor buffer in each rank's own shard (the value taken to
    the buffer's layout first)."""
    if not is_dtensor(buf):
        buf.copy_(value)
        return
    if tuple(value.placements) != tuple(buf.placements):
        value = value.redistribute(buf.device_mesh, buf.placements)
    buf.to_local().copy_(value.to_local())


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, `logaddexp(x, 0)`: `max(x, 0) + log1p(exp(-|x|))`,
    its derivative `exp(x - softplus(x))`, as jax's."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _chunking(S: int, chunk: int) -> tuple[int, int]:
    """(number of chunks, chunk length): the whole sequence is one chunk
    when S is not a multiple of the chunk."""
    Q = min(chunk, S)
    if S % Q != 0:
        return 1, S
    return S // Q, Q


def _run_chunks(body, h, inputs, Q: int, n_chunks: int, remat: bool):
    """The reference's `lax.scan` over chunks: `body(h, *chunk_inputs) ->
    (h, y)` on each Q-token slice of `inputs` (sequence on dim 1), the
    outputs concatenated along the sequence; each chunk checkpointed with
    `remat`."""
    ys = []
    # split, not slices: a slice's backward writes its gradient into zeros
    # of the whole input, a split's concatenates them once
    pieces = [a.split(Q, dim=1) for a in inputs]
    for c in range(n_chunks):
        sl = [piece[c] for piece in pieces]
        if remat:
            h, y = checkpoint(body, h, *sl, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = body(h, *sl)
        ys.append(y)
    return ys[0] if n_chunks == 1 else torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def _m1_dims(cfg: ModelConfig) -> tuple[int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, -(-cfg.d_model // 16))
    return d_inner, dt_rank


def mamba1_init(key: prng.Key, cfg: ModelConfig) -> PyTree:
    ks = prng.split(key, 8)
    D, N = cfg.d_model, cfg.ssm_state
    d_inner, dt_rank = _m1_dims(cfg)
    dev = key[0].device
    # S4D-real A init: A[:, n] = -(n+1); its block's rows and columns
    (_, rows), (col, cols) = leaf_block((d_inner, N), ("ssm_inner", "state"))
    A = torch.arange(col + 1, col + cols + 1, dtype=torch.float64,
                     device=dev).repeat(rows, 1)
    return {
        "norm": pz((D,), ("embed",), torch.float32, device=dev),
        "in_proj": p(ks[0], (D, 2 * d_inner), ("embed", "ssm_inner"),
                     cfg.dtype),
        "conv_w": p(ks[1], (d_inner, cfg.ssm_conv), ("ssm_inner", "conv"),
                    cfg.dtype, scale=0.5),
        "conv_b": pz((d_inner,), ("ssm_inner",), cfg.dtype, device=dev),
        "x_proj": p(ks[2], (d_inner, dt_rank + 2 * N), ("ssm_inner", None),
                    cfg.dtype),
        "dt_w": p(ks[3], (dt_rank, d_inner), (None, "ssm_inner"), cfg.dtype),
        "dt_b": pz((d_inner,), ("ssm_inner",), torch.float32, fill=-4.6,
                   device=dev),
        "A_log": (torch.log(A).float(), ("ssm_inner", "state")),
        "D_skip": pz((d_inner,), ("ssm_inner",), torch.float32, fill=1.0,
                     device=dev),
        "out_proj": p(ks[4], (d_inner, D), ("ssm_inner", "embed"),
                      cfg.dtype),
    }


def _m1_scan_chunk(h0, dA, dBx, C):
    """Sequential inner scan over one chunk.
    h0: (B,di,N); dA, dBx: (B,Q,di,N); C: (B,Q,N). Returns (hQ, y (B,Q,di)).

    The tokens' inputs are taken by `unbind`, whose backward stacks their
    gradients once; indexing token t would write each token's gradient
    into zeros of the whole chunk (Q passes over a (B,Q,di,N) tensor)."""
    h = h0
    ys = []
    for dA_t, dBx_t, C_t in zip(dA.unbind(1), dBx.unbind(1), C.unbind(1)):
        h = dA_t * h + dBx_t
        ys.append(torch.einsum("bdn,bn->bd", h, C_t))
    return h, torch.stack(ys, dim=1)


def _m1_chunk_body(A):
    def body(h, x_c, dt_c, B_c, C_c):
        dA = torch.exp(dt_c[..., None] * A)                   # (B,Q,di,N)
        dBx = (dt_c * x_c.float())[..., None] * B_c[:, :, None, :]
        return _m1_scan_chunk(h, dA, dBx, C_c.float())
    return body


def mamba1_mix(prm, xz: torch.Tensor, cfg: ModelConfig,
               chunk: int = _CHUNK) -> torch.Tensor:
    """Core selective-scan mixer. xz: (B,S,2*d_inner) post-in_proj."""
    _, dt_rank = _m1_dims(cfg)
    N = cfg.ssm_state
    x, z = torch.chunk(xz, 2, dim=-1)
    x = F.silu(_causal_conv(x, prm["conv_w"], prm["conv_b"]))
    x = constrain(x, ("batch", "seq", "ssm_inner"))

    proj = project("bsd,dk->bsk", x, prm["x_proj"])
    dt_r, B_, C_ = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = softplus(project("bsr,rd->bsd", dt_r, prm["dt_w"]).float()
                  + prm["dt_b"])                              # (B,S,di)
    A = -torch.exp(prm["A_log"])                              # (di,N)

    B, S, _ = x.shape
    n_chunks, Q = _chunking(S, chunk)
    remat = cfg.remat and torch.is_grad_enabled()

    def scan(x, dt, B_, C_, A):
        h0 = torch.zeros((x.shape[0], x.shape[2], N), dtype=torch.float32,
                         device=x.device)
        return _run_chunks(_m1_chunk_body(A), h0, (x, dt, B_, C_), Q,
                           n_chunks, remat)                   # (B,S,di)
    if is_dtensor(x):
        y = _m1_scan_local(scan, x, dt, B_.float(), C_, A)
    else:
        y = scan(x, dt, B_.float(), C_, A)
    y = y + x.float() * prm["D_skip"]
    return y.to(xz.dtype) * F.silu(z)


def _m1_scan_local(scan, x, dt, B_, C_, A):
    """`scan` on each rank's own rows and channels (`local_map`): the
    recurrence is elementwise over (batch, d_inner) and contracts over N
    alone, so each rank scans its shards of x and dt (x's placements)
    with B and C whole over the channels' mesh dims and its slice of A,
    where DTensor would dispatch the token loop op by op. Gradients: B's
    and C's a partial sum over the mesh dims that shard the channels,
    A's over those that shard the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    xp = tuple(x.placements)
    rows = tuple(pl.is_shard() and pl.dim == 0 for pl in xp)
    chans = tuple(pl.is_shard() and pl.dim == 2 for pl in xp)
    bc = tuple(Shard(0) if r else Replicate() for r in rows)
    a_pl = tuple(Shard(0) if c else Replicate() for c in chans)
    bc_grad = tuple(Partial() if c else pl for c, pl in zip(chans, bc))
    a_grad = tuple(Partial() if r else pl for r, pl in zip(rows, a_pl))
    args = (x, dt.redistribute(mesh, xp), B_.redistribute(mesh, bc),
            C_.redistribute(mesh, bc), A.redistribute(mesh, a_pl))
    return local_map(scan, out_placements=(xp,),
                     in_placements=(xp, xp, bc, bc, a_pl),
                     in_grad_placements=(xp, xp, bc_grad, bc_grad, a_grad),
                     device_mesh=mesh)(*args)


def mamba1_apply(prm, x, cfg: ModelConfig, positions=None) -> torch.Tensor:
    h = rms_norm(x, prm["norm"])
    xz = project("bsd,de->bse", h, prm["in_proj"])
    xz = constrain(xz, ("batch", "seq", "ssm_inner"))
    y = mamba1_mix(prm, xz, cfg)
    out = project("bse,ed->bsd", y, prm["out_proj"])
    return constrain(out, ("batch", "seq", "embed_act"))


def mamba1_init_cache(cfg: ModelConfig, batch: int, dtype, device=None
                      ) -> PyTree:
    """The conv window (batch, conv - 1, d_inner) in `dtype` and the state
    h (batch, d_inner, N) in float32, zeros on `device` (None: the CUDA
    card)."""
    device = resolve_device_or_meta(device)
    d_inner, _ = _m1_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def mamba1_decode(prm, x, cache, cfg: ModelConfig, pos=None):
    """One-token recurrent update. x: (B,1,D). Overwrites the cache's conv
    window and state; returns (out (B,1,D), cache)."""
    _, dt_rank = _m1_dims(cfg)
    N = cfg.ssm_state
    h_in = rms_norm(x[:, 0, :], prm["norm"])
    xz = project("bd,de->be", h_in, prm["in_proj"], keep_weights=True)
    x_t, z = torch.chunk(xz, 2, dim=-1)
    x_t, conv_state = _conv_step(x_t, cache["conv"], prm["conv_w"],
                                 prm["conv_b"])
    x_t = F.silu(x_t)
    proj = project("bd,dk->bk", x_t, prm["x_proj"], keep_weights=True)
    # the channels' partial sums reduced here, on (B, dt_rank + 2N): left
    # partial, C_ would have the state gathered over its channels
    proj = constrain(proj, ("batch", None))
    dt_r, B_, C_ = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = softplus(project("br,rd->bd", dt_r, prm["dt_w"],
                          keep_weights=True).float() + prm["dt_b"])
    A = -torch.exp(prm["A_log"])
    dA = torch.exp(dt[..., None] * A)                          # (B,di,N)
    dBx = (dt * x_t.float())[..., None] * B_[:, None, :].float()
    h_new = dA * cache["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h_new, C_.float())
    y = y + x_t.float() * prm["D_skip"]
    y = y.to(x.dtype) * F.silu(z)
    out = project("be,ed->bd", y, prm["out_proj"], keep_weights=True)[
        :, None, :]
    _write_state(cache["conv"], conv_state)
    _write_state(cache["h"], h_new)
    return constrain(out, ("batch", "seq", "embed_act")), cache


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


def _m2_dims(cfg: ModelConfig) -> tuple[int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads


def _linspace(start: float, stop: float, num: int, device=None,
              block: tuple[int, int] | None = None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in float32 as the reference's jitted
    init computes it: `start * (1 - s) + stop * s` with `s = i * (1 /
    (num - 1))` (XLA turns the division by the constant into a product by
    its reciprocal), and the end point exact. `block` (offset, length)
    computes those elements alone."""
    lo, n = block if block is not None else (0, num)
    f32 = dict(dtype=torch.float32, device=device)
    if num == 1:
        return torch.full((n,), start, **f32)
    div = num - 1
    i = torch.arange(lo, min(lo + n, div), **f32)
    s = i * torch.tensor(1.0 / div, **f32)
    out = start * (1.0 - s) + stop * s
    if lo + n <= div:
        return out
    return torch.cat([out, torch.full((1,), stop, **f32)])


def mamba2_init(key: prng.Key, cfg: ModelConfig) -> PyTree:
    ks = prng.split(key, 6)
    D, N = cfg.d_model, cfg.ssm_state
    d_inner, nheads = _m2_dims(cfg)
    conv_dim = d_inner + 2 * N  # x plus (B,C), single group
    d_proj = 2 * d_inner + 2 * N + nheads
    dev = key[0].device
    A = _linspace(1.0, 16.0, nheads, device=dev,
                  block=leaf_block((nheads,), ("ssm_heads",))[0])
    return {
        "norm": pz((D,), ("embed",), torch.float32, device=dev),
        "in_proj": p(ks[0], (D, d_proj), ("embed", "ssm_inner"), cfg.dtype),
        "conv_w": p(ks[1], (conv_dim, cfg.ssm_conv), ("ssm_inner", "conv"),
                    cfg.dtype, scale=0.5),
        "conv_b": pz((conv_dim,), ("ssm_inner",), cfg.dtype, device=dev),
        "A_log": (torch.log(A.double()).float(), ("ssm_heads",)),
        "dt_bias": pz((nheads,), ("ssm_heads",), torch.float32, fill=-4.6,
                      device=dev),
        "D_skip": pz((nheads,), ("ssm_heads",), torch.float32, fill=1.0,
                     device=dev),
        "gate_norm": pz((d_inner,), ("ssm_inner",), torch.float32,
                        device=dev),
        "out_proj": p(ks[2], (d_inner, D), ("ssm_inner", "embed"),
                      cfg.dtype),
    }


def _ssd_chunk(h0, x_c, dt_c, B_c, C_c, A):
    """SSD matmul form for one chunk.
    h0: (B,H,P,N); x_c: (B,Q,H,P); dt_c: (B,Q,H); B_c, C_c: (B,Q,N);
    A: (H,) negative reals. Returns (hQ, y_c (B,Q,H,P)).

    The reference's three-operand einsums are the two products its XLA
    program contracts, in that order: y_inter as (exp(cum) C) then h0,
    the state update as (exp(total - cum) B) then x dt. The values are the
    reference's; the gradient is too wherever the reference's is finite,
    and stays finite where a chunk's decay passes exp's range (above 88.7
    in log), where the reference's is NaN."""
    dA = dt_c * A                                    # (B,Q,H)  log-decay
    cum = torch.cumsum(dA, dim=1)                    # (B,Q,H)
    # intra-chunk: L[s,t] = exp(cum_s - cum_t) for s >= t, and 0 above
    # the diagonal as exp(-inf): the reference's where(mask, exp(rel), 0)
    # gives the same values, but where rel overflows exp above the
    # diagonal its gradient is 0 * inf = NaN
    rel = cum[:, :, None, :] - cum[:, None, :, :]    # (B,Q,Q,H)
    Q = x_c.shape[1]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x_c.device).tril()
    L = torch.exp(torch.where(mask[None, :, :, None], rel,
                              torch.full((), float("-inf"),
                                         dtype=rel.dtype,
                                         device=rel.device)))
    scores = torch.einsum("bsn,btn->bst", C_c, B_c)  # (B,Q,Q)
    W = scores[..., None] * L                        # (B,Q,Q,H)
    xdt = x_c * dt_c[..., None]                      # (B,Q,H,P)
    y_intra = torch.einsum("bsth,bthp->bshp", W, xdt)
    # inter-chunk: contribution of h0 decayed to each position
    decay0 = torch.exp(cum)                          # (B,Q,H)
    y_inter = torch.einsum("bshn,bhpn->bshp",
                           decay0[..., None] * C_c[:, :, None, :], h0)
    # state update: hQ = exp(sum dA) h0 + sum_t exp(cum_Q - cum_t) dB_t x_t
    total = cum[:, -1, :]                            # (B,H)
    decay_t = torch.exp(total[:, None, :] - cum)     # (B,Q,H)
    hQ = (torch.exp(total)[..., None, None] * h0
          + torch.einsum("bthp,bthn->bhpn", xdt,
                         decay_t[..., None] * B_c[:, :, None, :]))
    return hQ, y_intra + y_inter


def _m2_chunk_body(A):
    def body(h, x_c, dt_c, B_c, C_c):
        return _ssd_chunk(h, x_c.float(), dt_c, B_c.float(), C_c.float(), A)
    return body


def mamba2_mix(prm, zxbcdt: torch.Tensor, cfg: ModelConfig,
               chunk: int = _CHUNK) -> torch.Tensor:
    """Core SSD mixer. zxbcdt: (B,S,2*di+2*N+H) post-in_proj."""
    d_inner, nheads = _m2_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    z, xBC, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, nheads],
                                 dim=-1)
    xBC = F.silu(_causal_conv(xBC, prm["conv_w"], prm["conv_b"]))
    x, B_, C_ = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = softplus(dt_raw.float() + prm["dt_bias"])
    A = -torch.exp(prm["A_log"])                     # (H,)

    B, S, _ = zxbcdt.shape
    n_chunks, Q = _chunking(S, chunk)
    x = x.reshape(B, S, nheads, P)
    remat = cfg.remat and torch.is_grad_enabled()

    def scan(x, dt, B_, C_, A):
        h0 = torch.zeros((x.shape[0], x.shape[2], P, N), dtype=torch.float32,
                         device=x.device)
        return _run_chunks(_m2_chunk_body(A), h0, (x, dt, B_, C_), Q,
                           n_chunks, remat)          # (B,S,H,P)
    if is_dtensor(x):
        y = _ssd_local(scan, x, dt, B_, C_, A)
    else:
        y = scan(x, dt, B_, C_, A)
    y = y + x.float() * prm["D_skip"][:, None]
    y = y.reshape(B, S, d_inner)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    return rms_norm(y.to(zxbcdt.dtype) * F.silu(z), prm["gate_norm"])


def _ssd_local(scan, x, dt, B_, C_, A):
    """`scan`, the chunked SSD, on each rank's own rows and heads
    (`local_map`), as `_m1_scan_local` runs Mamba-1's: the SSD is
    elementwise over (batch, heads) and contracts B and C over N alone,
    so each rank scans its rows and heads of x (B,S,H,P) and dt (B,S,H)
    with B and C (B,S,N) whole over the heads' mesh dims and its slice of
    A (H,). x is taken whole along its sequence and head dim, and sliced
    to A's head shards where it lies whole over them. Gradients: B's and
    C's a partial sum over the mesh dims that shard the heads, A's over
    those that shard the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    xp = tuple(pl if pl.is_shard(0) or pl.is_shard(2) else
               Shard(2) if a.is_shard(0) else Replicate()
               for pl, a in zip(x.placements, A.placements))
    rows = tuple(pl.is_shard(0) for pl in xp)
    heads = tuple(pl.is_shard(2) for pl in xp)
    bc = tuple(Shard(0) if r else Replicate() for r in rows)
    a_pl = tuple(Shard(0) if h else Replicate() for h in heads)
    bc_grad = tuple(Partial() if h else pl for h, pl in zip(heads, bc))
    a_grad = tuple(Partial() if r else pl for r, pl in zip(rows, a_pl))
    args = (x.redistribute(mesh, xp), dt.redistribute(mesh, xp),
            B_.redistribute(mesh, bc), C_.redistribute(mesh, bc),
            A.redistribute(mesh, a_pl))
    return local_map(scan, out_placements=(xp,),
                     in_placements=(xp, xp, bc, bc, a_pl),
                     in_grad_placements=(xp, xp, bc_grad, bc_grad, a_grad),
                     device_mesh=mesh)(*args)


def mamba2_apply(prm, x, cfg: ModelConfig, positions=None) -> torch.Tensor:
    h = rms_norm(x, prm["norm"])
    zxbcdt = project("bsd,de->bse", h, prm["in_proj"])
    zxbcdt = constrain(zxbcdt, ("batch", "seq", "ssm_inner"))
    y = mamba2_mix(prm, zxbcdt, cfg)
    out = project("bse,ed->bsd", y, prm["out_proj"])
    return constrain(out, ("batch", "seq", "embed_act"))


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype, device=None
                      ) -> PyTree:
    """The conv window over x, B and C (batch, conv - 1, d_inner + 2 N) in
    `dtype` and the state h (batch, heads, head_dim, N) in float32, zeros
    on `device` (None: the CUDA card)."""
    device = resolve_device_or_meta(device)
    d_inner, nheads = _m2_dims(cfg)
    conv_dim = d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def mamba2_decode(prm, x, cache, cfg: ModelConfig, pos=None):
    """One-token SSD update. x: (B,1,D). Overwrites the cache's conv window
    and state; returns (out (B,1,D), cache)."""
    d_inner, nheads = _m2_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    h_in = rms_norm(x[:, 0, :], prm["norm"])
    zxbcdt = project("bd,de->be", h_in, prm["in_proj"], keep_weights=True)
    z, xBC, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, nheads],
                                 dim=-1)
    xBC, conv_state = _conv_step(xBC, cache["conv"], prm["conv_w"],
                                 prm["conv_b"])
    xBC = F.silu(xBC)
    x_t, B_, C_ = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = softplus(dt_raw.float() + prm["dt_bias"])            # (B,H)
    A = -torch.exp(prm["A_log"])
    dA = torch.exp(dt * A)                                     # (B,H)
    x_t = x_t.reshape(-1, nheads, P).float()
    dBx = torch.einsum("bhp,bn->bhpn", x_t * dt[..., None], B_.float())
    h_new = dA[..., None, None] * cache["h"] + dBx
    y = torch.einsum("bhpn,bn->bhp", h_new, C_.float())
    y = y + x_t * prm["D_skip"][:, None]
    y = y.reshape(-1, d_inner)
    y = rms_norm(y.to(x.dtype) * F.silu(z), prm["gate_norm"])
    out = project("be,ed->bd", y, prm["out_proj"], keep_weights=True)[
        :, None, :]
    _write_state(cache["conv"], conv_state)
    _write_state(cache["h"], h_new)
    return constrain(out, ("batch", "seq", "embed_act")), cache
