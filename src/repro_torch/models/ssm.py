"""Mamba-2 blocks via SSD (state-space duality, arXiv:2405.21060) — the
counterpart of ``repro/models/ssm.py``.

Training and prefill run the chunked SSD: within a chunk the recurrence
in its quadratic dual form, and a [H, P, N] state passed from chunk to
chunk. On a CUDA tensor the prefill's scan is the hand-written kernel
(``kernels/ssd_scan``), which takes the TPU kernel's place; on the CPU it
is the plain chunked twin ``ssd_chunked`` below, so the CPU tests compare
like with like. Decode is the O(1) recurrent update.

In a sharded step whose rules split the mixer over ``model`` and where
``model`` divides the heads, the mixer is tensor-parallel
(``sharding.local_params``): each rank computes its H/m heads. The
packed leaves (``in_proj`` = [z | x B C | dt], the conv's [x | B | C])
have ``model`` blocks that do not follow heads, so the rank takes them
whole (``TensorParallel.whole``: the gradient summed over ``model``) and
cuts its columns before the product (``local_columns``): its z, x and dt
and every group's B and C. The SSD runs at the rank's heads
(``local_groups`` picks the B/C groups they read); the gated RMSNorm's
mean over d_inner sums each rank's squares over ``model`` (an
all-reduce, and an all-reduce back); ``out_proj`` is row-parallel, the
sum over ``model`` after it. The decode state holds the rank's heads in
place; the conv tail, packed like the conv, is rebuilt whole (the x
columns gathered over ``model``) for the rank's block to be written
back.

Under context parallelism (``sharding.context_parallel``) a rank's
segment runs the conv with the previous segment's last d_conv - 1 inputs
as its leading context (``sharding.halo``); its SSD forms the segment's
final state from zero in float32 (the kernels' ``ssd_final_cuda`` entry
on the card), the segments' final states and decays (the product of
their chunks' exp(sum dt A)) are all-gathered, each segment forms the
state h_in entering it from the earlier ones (``sharding.segment_carry``)
and runs the scan from it (``h0``: the kernel on the card), so that the
state enters every chunk as the unsharded chunk loop carries it, in
float32. A prefill's cache is the state after the last segment and the
last segment's conv tail, the same on every rank.

Shapes: x [B, S, H, P] (H heads × P head_dim = d_inner), B/C [B, S, G, N]
(G groups broadcast over heads), dt [B, S, H], A [H] (negative).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, ones_init, zeros_init
from repro_torch.numerics import softplus
from repro_torch.runtime import sharding


# ---------------------------------------------------------------------------
# Core SSD scan (chunked)
# ---------------------------------------------------------------------------

def _segsum(a):
    """Stable segment-sum: out[..., i, j] = sum a[..., j+1..i] (−inf j>i)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, -torch.inf)


def work_dtype(x) -> torch.dtype:
    """The type the plain SSD computes in: float32, as the reference does
    (whose JAX has no float64 by default), or float64 for float64 inputs,
    so that a float64 step is free of float32 rounding in its SSD as it is
    elsewhere (the kernels take float32 and bf16 only)."""
    return torch.promote_types(x.dtype, torch.float32)


def _chunks(x, dt, A, Bm, Cm, chunk: int):
    """(x·dt, dt·A, B, C) in ``work_dtype(x)``, padded to whole chunks and
    cut into them: [B, nc, L, ...], B and C repeated over their groups'
    heads."""
    b, S, H, _ = x.shape
    G = Bm.shape[2]
    pad = (-S) % chunk
    if pad:
        # dt=0 padding is exact: a = dt·A = 0 ⇒ decay 1 (state preserved),
        # x·dt = 0 ⇒ nothing injected; padded outputs are sliced away.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk
    rep = H // G

    w = work_dtype(x)
    xf = x.to(w)
    a = dt.to(w) * A.to(w)                                    # [B,S,H] (<0)
    xdt = xf * dt.to(w)[..., None]                            # fold dt into x
    Bf = Bm.to(w).repeat_interleave(rep, dim=2)               # [B,S,H,N]
    Cf = Cm.to(w).repeat_interleave(rep, dim=2)

    def to_chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])
    return tuple(map(to_chunks, (xdt, a, Bf, Cf)))


def _next_state(state, xk, Bk, acs):
    """The state after a chunk: the old one decayed, this chunk's
    injected."""
    decay_tail = torch.exp(acs[:, -1:, :] - acs)               # [B,L,H]
    return (state * torch.exp(acs[:, -1, :])[..., None, None]
            + torch.einsum("blhn,blhp,blh->bhpn", Bk, xk, decay_tail))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 256, init_state=None):
    """Returns (y [B,S,H,P], final_state [B,H,P,N]), in x's dtype; float32
    inside (``work_dtype``). ``init_state`` [B,H,P,N]: the state entering
    the first chunk (zero where None)."""
    y, state = _ssd_loop(x, dt, A, Bm, Cm, chunk, init_state)
    return y, state.to(x.dtype)


def _ssd_loop(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """``ssd_chunked`` with the final state in ``work_dtype(x)``."""
    b, S, H, Pd = x.shape
    N = Bm.shape[3]
    xc, ac, Bc, Cc = _chunks(x, dt, A, Bm, Cm, chunk)
    nc = xc.shape[1]
    w = work_dtype(x)
    state = (torch.zeros((b, H, Pd, N), dtype=w, device=x.device)
             if init_state is None else init_state.to(w))
    ys = []
    for k in range(nc):
        xk, ak, Bk, Ck = xc[:, k], ac[:, k], Bc[:, k], Cc[:, k]
        acs = torch.cumsum(ak, dim=1)                          # [B,L,H]
        # Intra-chunk (dual quadratic form):
        Lmat = torch.exp(_segsum(ak.transpose(1, 2)))          # [B,H,L,L]
        scores = torch.einsum("blhn,bshn->bhls", Ck, Bk) * Lmat
        y_intra = torch.einsum("bhls,bshp->blhp", scores, xk)
        # Inter-chunk: contribution of the carried state.
        y_inter = torch.einsum("blhn,bhpn,blh->blhp", Ck, state,
                               torch.exp(acs))
        # New state: decay old + inject this chunk.
        state = _next_state(state, xk, Bk, acs)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, H, Pd)[:, :S]
    return y.to(x.dtype), state


def ssd_final_state(x, dt, A, Bm, Cm, chunk: int = 256):
    """The final state [B,H,P,N] of ``ssd_chunked`` from a zero state, in
    ``work_dtype(x)`` (float32 but for float64 inputs), without forming y:
    the chunk loop's state updates alone, in its order (bitwise its final
    before the cast to x's dtype). The plain twin of the kernels'
    ``ssd_final_cuda`` entry."""
    b, _, H, Pd = x.shape
    xc, ac, Bc, _ = _chunks(x, dt, A, Bm, Cm, chunk)
    state = torch.zeros((b, H, Pd, Bm.shape[3]), dtype=work_dtype(x),
                        device=x.device)
    for k in range(xc.shape[1]):
        state = _next_state(state, xc[:, k], Bc[:, k],
                            torch.cumsum(ac[:, k], dim=1))
    return state


def chunk_decay(dt, A, chunk: int, dtype=torch.float32):
    """[B, H]: the product over a sequence's chunks of each chunk's decay
    exp(sum dt·A), in ``dtype``: what the scan multiplies a state entering
    the sequence by on its way through, in the chunk loop's order (each
    chunk's cumsum, as ``ssd_chunked`` forms it)."""
    a = dt.to(dtype) * A.to(dtype)
    a = F.pad(a, (0, 0, 0, (-a.shape[1]) % chunk))
    acs = torch.cumsum(a.unflatten(1, (-1, chunk)), dim=2)    # [B,nc,L,H]
    out = torch.exp(acs[:, 0, -1])
    for k in range(1, acs.shape[1]):
        out = out * torch.exp(acs[:, k, -1])
    return out


def ssd_step(x, dt, A, Bm, Cm, state):
    """O(1) decode: x [B,1,H,P], state [B,H,P,N] → (y, new_state)."""
    rep = state.shape[1] // Bm.shape[2]
    Bf = Bm.to(torch.float32).repeat_interleave(rep, dim=2)[:, 0]  # [B,H,N]
    Cf = Cm.to(torch.float32).repeat_interleave(rep, dim=2)[:, 0]
    a = torch.exp(dt.to(torch.float32)[:, 0] * A.to(torch.float32))  # [B,H]
    xdt = (x.to(torch.float32) * dt.to(torch.float32)[..., None])[:, 0]
    state_new = (state.to(torch.float32) * a[..., None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bf, xdt))
    y = torch.einsum("bhn,bhpn->bhp", Cf, state_new)
    return y[:, None].to(x.dtype), state_new.to(state.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 block (in_proj → conv → SSD → gate → out_proj)
# ---------------------------------------------------------------------------

def block_init(gen, d_model, *, d_inner, head_dim, n_groups, d_state,
               d_conv=4, dtype=torch.float32) -> dict:
    """The reference's parameter tree (P leaves) and init: the conv and
    the SSM scalars start at zero (A_log 0, D 1), so the SSD carries zeros
    until trained; draws in the order in_proj, out_proj."""
    H = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * d_state
    dev = gen.device
    return dict(
        in_proj=dense_init(gen, (d_model,
                                 2 * d_inner + 2 * n_groups * d_state + H),
                           ("embed", "mlp"), dtype),
        conv_w=zeros_init((d_conv, conv_dim), ("conv", "mlp"), dtype, dev),
        conv_b=zeros_init((conv_dim,), ("mlp",), dtype, dev),
        A_log=zeros_init((H,), ("heads_nosplit",), torch.float32, dev),
        D=ones_init((H,), ("heads_nosplit",), torch.float32, dev),
        dt_bias=zeros_init((H,), ("heads_nosplit",), torch.float32, dev),
        norm_scale=zeros_init((d_inner,), ("mlp",), dtype, dev),
        out_proj=dense_init(gen, (d_inner, d_model), ("mlp", "embed"),
                            dtype, fan_in=d_inner),
    )


def draw_live_mixer(rng: np.random.Generator, cfg) -> dict:
    """The Mamba-2 mixer parameters that ``block_init`` leaves at zero or
    one (conv_w, conv_b, A_log, dt_bias, D, norm_scale), drawn from
    ``rng`` at the scales of Mamba-2's published init: conv taps and bias
    uniform within 1/sqrt(d_conv), A = -U(1, 16), dt in log-U(1e-3, 0.1)
    through the inverse softplus. With the zero conv of ``block_init`` the
    SSD carries exactly zero (silu(0) = 0); with these it carries signal.
    Float32 numpy arrays under ``block_init``'s names, one layer."""
    H = cfg.d_inner // cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    out = dict(conv_w=rng.uniform(-0.5, 0.5, (4, conv_dim)),
               conv_b=rng.uniform(-0.5, 0.5, conv_dim),
               A_log=np.log(rng.uniform(1.0, 16.0, H)),
               dt_bias=dt + np.log(-np.expm1(-dt)),
               D=rng.uniform(0.5, 1.5, H),
               norm_scale=rng.normal(0.0, 0.1, cfg.d_inner))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv, width d_conv, then SiLU. u: [B, S, C];
    w: [d_conv, C]; b: [C]. Taps are summed in the reference's order.

    state: [B, d_conv-1, C] trailing context for decode. Returns (y, new
    state of the last d_conv-1 inputs)."""
    d_conv = w.shape[0]
    if state is None:
        u_pad = F.pad(u, (0, 0, d_conv - 1, 0))
    else:
        u_pad = torch.cat([state.to(u.dtype), u], dim=1)
    S = u.shape[1]
    y = sum(u_pad[:, i:i + S, :] * w[i] for i in range(d_conv))
    new_state = u_pad[:, -(d_conv - 1):, :]
    return F.silu(y + b), new_state


def segment_conv(u, w, b, cp):
    """``_causal_conv`` of this rank's segment of a sequence (``cp``, its
    ``ContextParallel``): the previous segment's last d_conv - 1 inputs
    lead it (``sharding.halo``; zeros before the first). Returns (y, the
    last segment's last d_conv - 1 inputs: the conv cache a prefill of
    the whole sequence leaves)."""
    width = w.shape[0] - 1
    if u.shape[1] < width:
        raise ValueError(f"a sequence segment of {u.shape[1]} positions is "
                         f"shorter than the causal conv's context of "
                         f"{width}")
    before, last = sharding.halo(u[:, u.shape[1] - width:], cp)
    return _causal_conv(u, w, b, before)[0], last


def _scan(xs, dt, A, Bm, Cm, chunk, cp=None):
    """The prefill's SSD, (y, final state) in x's dtype: the kernel on the
    card, the plain twin on the CPU (the same chunk length either way);
    with ``cp`` (a segment of a sequence) ``_SegmentScan``, whose final
    state is the last segment's."""
    if xs.device.type == "cuda":
        xs, Bm, Cm = xs.contiguous(), Bm.contiguous(), Cm.contiguous()
    if cp is not None:
        return _SegmentScan.apply(cp, chunk, xs, dt, A, Bm, Cm)
    if xs.device.type == "cuda":
        # Imported here: the kernel's plain version imports this module.
        from repro_torch.kernels.ssd_scan import ops
        return ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=chunk)
    return ssd_chunked(xs, dt, A, Bm, Cm, chunk=chunk)


def _plain_segment(x, dt, A, Bm, Cm, h0, *, chunk):
    return _ssd_loop(x, dt, A, Bm, Cm, chunk, h0)


class _SegmentScan(torch.autograd.Function):
    """A segment's SSD under context parallelism (``cp``), from the state
    the earlier segments hand on.

    Forward: the segment's final state from zero in float32 (the kernels'
    ``ssd_final_cuda`` entry on the card; ``ssd_final_state`` on the CPU,
    in ``work_dtype``); the segments' finals and decays (``chunk_decay``:
    the product of their chunks') exchanged by ``sharding.segment_carry``,
    which gives the state h_in entering this segment and the state after
    the last; then the scan from h_in (``h0`` of the kernel;
    ``init_state`` of the plain version), so that the state enters each
    chunk as the unsharded chunk loop carries it, in float32 or wider.
    Returns (y, the last state in x's dtype).

    Backward: the unsharded loop's, segment by segment. The cotangent that
    y puts on h_in (the scan's vjp in h0 alone) and the decays are
    exchanged over the segments (``sharding.segment_carry_cotangent``,
    the adjoint of ``segment_carry``), which gives the total cotangent on
    the state leaving this segment; then one vjp of the scan from h_in
    with cotangents (dy, that state's) gives the segment's input
    gradients, the two cotangents merged chunk by chunk in the unsharded
    order. So dt and A, float32 in the model, take their gradients from
    one vjp, rounded to float32 once, as in the unsharded step. Autograd
    through the three parts (the from-zero final, the decays, the scan
    from h_in) rounds three float32 gradients of dt and A and sums them:
    a reduced mamba2 float64 step's layer-1 ``dt_bias`` gradient, a sum
    with much cancellation, then lands 2.61e-6 of its largest entry off
    the unsharded step's at S 64 on (4, 1) (1.31e-6 with dt and A widened
    to float64 before the three parts), this backward 1.63e-7. The vjps
    are of the plain version, as ``ops.ssd_scan``'s backward is."""

    @staticmethod
    def forward(ctx, cp, chunk, xs, dt, A, Bm, Cm):
        # Imported here: the kernel's plain version imports this module.
        from repro_torch.kernels.ssd_scan import ops
        decay = chunk_decay(dt, A, chunk, work_dtype(xs))
        h_in, last = sharding.segment_carry(
            ops.ssd_final(xs, dt, A, Bm, Cm, chunk=chunk),
            decay[..., None, None], cp)
        y, _ = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=chunk, h0=h_in)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(xs, dt, A, Bm, Cm, h_in, decay)
            ctx.cp, ctx.chunk = cp, chunk
        return y, last.to(xs.dtype)

    @staticmethod
    def backward(ctx, gy, glast):
        from repro_torch.kernels import plain_vjp
        xs, dt, A, Bm, Cm, h_in, decay = ctx.saved_tensors
        plain = functools.partial(_plain_segment, chunk=ctx.chunk)
        local, = plain_vjp(lambda h0: plain(xs, dt, A, Bm, Cm, h0)[0],
                           (h_in,), (gy,))
        out = sharding.segment_carry_cotangent(local, decay,
                                               glast.to(local.dtype), ctx.cp)
        grads = plain_vjp(plain, (xs, dt, A, Bm, Cm, h_in), (gy, out))
        return (None, None, *grads[:5])


def local_columns(d_inner: int, gn: int, n_heads: int, rank: int,
                  ways: int) -> tuple:
    """(the ``in_proj`` column ranges, the conv column ranges) of rank
    ``rank``'s heads of ``n_heads`` split ``ways`` ways, with ``gn`` =
    groups × state: its z, x, every group's B and C, its dt of [z | x B C
    | dt]; its x and every B and C of the conv's [x | B | C]. Concatenated
    in order they give [z | x B C | dt] and [x | B | C] at its heads."""
    dl, hl = d_inner // ways, n_heads // ways
    own = slice(rank * dl, (rank + 1) * dl)        # the heads' channels
    bc = slice(d_inner, d_inner + 2 * gn)
    dt0 = 2 * d_inner + 2 * gn
    return ((own, slice(d_inner + own.start, d_inner + own.stop),
             slice(d_inner + bc.start, d_inner + bc.stop),
             slice(dt0 + rank * hl, dt0 + (rank + 1) * hl)),
            (own, bc))


def local_groups(t, n_heads: int, lo: int, hl: int):
    """The B or C groups [B, S, G, N] that heads ``[lo, lo + hl)`` read,
    as [B, S, G', N] with hl a multiple of G' (local head j reads group
    j // (hl / G'), as the SSD broadcasts them): a range of whole groups,
    the one group a range of heads lies in, or one group a head."""
    per = n_heads // t.shape[2]
    if hl % per == 0:
        return t[:, :, lo // per:(lo + hl) // per]
    if per % hl == 0:
        return t[:, :, lo // per:lo // per + 1]
    return t.repeat_interleave(per, dim=2)[:, :, lo:lo + hl]


def _cut(t, ranges, dim: int = -1):
    return torch.cat([t.narrow(dim, r.start, r.stop - r.start)
                      for r in ranges], dim=dim)


def block_apply(x, p, cfg, mode="train", cache=None, chunk=256):
    """cfg: object with d_inner, ssm_head_dim, ssm_groups, ssm_state.
    mode: train (no cache out) | prefill (returns final state as cache) |
    decode (cache: dict(conv=[B,3,C], state=[B,H,P,N]), O(1) update)."""
    d_inner = cfg.d_inner
    Pd, G, N = cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    H = d_inner // Pd

    p, tp = sharding.local_params(p, divides=(H,))
    x = sharding.sublayer_in(x, tp)
    Bsz, S, _ = x.shape
    w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    hl, dl, heads = H, d_inner, slice(None)
    conv_state = None if mode != "decode" else cache["conv"]
    if tp is not None:
        hl, dl, heads = H // tp.size, d_inner // tp.size, tp.block(H)
        cols, conv_cols = local_columns(d_inner, G * N, H, tp.rank, tp.size)
        w_in = _cut(tp.whole(w_in, 1, 2 * d_inner + 2 * G * N + H), cols)
        conv_dim = d_inner + 2 * G * N
        conv_w = _cut(tp.whole(conv_w, 1, conv_dim), conv_cols)
        conv_b = _cut(tp.whole(conv_b, 0, conv_dim), conv_cols)
        if conv_state is not None:
            conv_state = _cut(conv_state, conv_cols)

    zxbcdt = x @ w_in.to(x.dtype)
    z, xbc, dt_raw = torch.split(zxbcdt, [dl, dl + 2 * G * N, hl], dim=-1)
    cp = None if mode == "decode" else sharding.context_parallel()
    conv = _causal_conv if cp is None else segment_conv
    xbc, conv_state = conv(xbc, conv_w.to(x.dtype), conv_b.to(x.dtype),
                           conv_state if cp is None else cp)
    xs, Bm, Cm = torch.split(xbc, [dl, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, S, hl, Pd)
    Bm = Bm.reshape(Bsz, S, G, N)
    Cm = Cm.reshape(Bsz, S, G, N)
    if tp is not None:
        Bm = local_groups(Bm, H, heads.start, hl)
        Cm = local_groups(Cm, H, heads.start, hl)
        if mode != "train":
            # the packed tail whole: every rank's x columns, then B and C
            conv_state = torch.cat([tp.gather(conv_state[..., :dl], -1),
                                    conv_state[..., dl:]], dim=-1)
    dt = softplus(dt_raw.to(torch.float32)
                  + p["dt_bias"][heads].to(torch.float32))
    A = -torch.exp(p["A_log"][heads].to(torch.float32))

    if mode == "decode":
        y, ssm_state = ssd_step(xs, dt, A, Bm, Cm, cache["state"])
        new_cache = dict(conv=conv_state, state=ssm_state)
    else:
        y, final = _scan(xs, dt, A, Bm, Cm, min(chunk, S), cp)
        new_cache = (dict(conv=conv_state, state=final)
                     if mode == "prefill" else None)

    y = y + xs * p["D"][heads].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, dl)
    # Gated RMSNorm (Mamba-2 norm-before-out_proj), its mean over every
    # channel of d_inner.
    y = y * F.silu(z)
    sq = torch.square(y.to(torch.float32))
    if tp is None:
        var = torch.mean(sq, -1, keepdim=True)
    else:
        var = tp.sum(sq.sum(-1, keepdim=True)) / d_inner
    y = (y.to(torch.float32) * torch.rsqrt(var + 1e-6)
         * (1.0 + p["norm_scale"].to(torch.float32))).to(x.dtype)
    out = y @ p["out_proj"].to(x.dtype)
    return sharding.sublayer_out(out, tp), new_cache
