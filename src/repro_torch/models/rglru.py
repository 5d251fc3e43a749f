"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
the counterpart of ``repro/models/rglru.py``.

    r_t = sigmoid(W_a x_t + b_a)           recurrence gate
    i_t = sigmoid(W_x x_t + b_x)           input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block is in_x / in_gate projections -> conv1d(4) -> RG-LRU -> gated
output projection, in three modes: ``train``, ``prefill`` (also returns the
decode cache) and ``decode`` (one step, O(1)). The RG-LRU after its two
gate matmuls is a ``layer(pre_r, pre_i, x, lam)``. Over a sequence it is
``rglru_scan``: on a CUDA tensor the fused kernel
(``kernels.rglru_scan.ops.rglru_layer``, gate math and recurrence in one
launch), on the CPU its plain version, a sequential loop (the reference
uses an associative scan; both compute the same recurrence). The learned
forecaster passes its own ``layer`` in train mode. Decode is plain
PyTorch, as the reference's is plain jnp.

In a sharded step whose rules split the channels over ``model``
(``sharding.local_params``) the block is tensor-parallel: ``in_x`` and
``in_gate`` are column-parallel (the rank's W/m channels), the conv, the
gate biases, ``lam`` and the decode cache are the rank's channel blocks,
and ``w_a`` / ``w_x`` are split by input rows, so each rank's float32
product of its channels is a partial sum over every output channel,
reduce-scattered over ``model`` to the rank's channels (the backward an
all-gather) before the recurrence runs on them — through the fused
kernel on the card. ``out`` is row-parallel, the sum over ``model``
after it.

Under context parallelism (``sharding.context_parallel``) a rank's
segment runs the conv with the previous segment's tail as its leading
context (``ssm.segment_conv``) and the fused layer from h = 0; the
segments' final states and products of a are all-gathered, each forms
the state h_in entering it (``sharding.segment_carry``) and runs its
recurrence again from h_in through the ``h0`` path (a virtual step 0 of
a = 1, bx = h_in) — the scan-only kernel on the card. That equals the
fused layer's output plus the carried term prod_{s<=t} a_s h_in, for the
same one scan, and steps in the unsharded recurrence's order from the
incoming state (the float64 steps' gradients then stay about twice as
close to the unsharded step's). A prefill's cache is the state after the
last segment and the last segment's conv tail, the same on every rank.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import rglru_gates
from repro_torch.models.common import dense_init, zeros_init
from repro_torch.models.ssm import _causal_conv, segment_conv
from repro_torch.runtime import sharding


def block_init(gen: torch.Generator, d_model: int, *, lru_width: int,
               d_conv: int = 4, dtype=torch.float32) -> dict:
    """The reference's parameter tree (P leaves), layouts and init (zero
    conv, gate biases and lam; lam float32 whatever ``dtype``); the random
    draws come from ``gen`` in the order in_x, in_gate, w_a, w_x, out."""
    dev = gen.device
    return dict(
        in_x=dense_init(gen, (d_model, lru_width), ("embed", "mlp"), dtype),
        in_gate=dense_init(gen, (d_model, lru_width), ("embed", "mlp"),
                           dtype),
        conv_w=zeros_init((d_conv, lru_width), ("conv", "mlp"), dtype, dev),
        conv_b=zeros_init((lru_width,), ("mlp",), dtype, dev),
        w_a=dense_init(gen, (lru_width, lru_width), ("mlp", "mlp_in"),
                       dtype, fan_in=lru_width),
        b_a=zeros_init((lru_width,), ("mlp",), dtype, dev),
        w_x=dense_init(gen, (lru_width, lru_width), ("mlp", "mlp_in"),
                       dtype, fan_in=lru_width),
        b_x=zeros_init((lru_width,), ("mlp",), dtype, dev),
        lam=zeros_init((lru_width,), ("mlp",), torch.float32, dev),
        out=dense_init(gen, (lru_width, d_model), ("mlp", "embed"), dtype,
                       fan_in=lru_width),
    )


def draw_live_block(rng: np.random.Generator, cfg) -> dict:
    """The RG-LRU block parameters that ``block_init`` leaves at zero
    (conv_w, conv_b, b_a, b_x, lam), drawn from ``rng`` at Griffin's
    published scales: conv taps and bias uniform within 1/sqrt(d_conv),
    lam such that a = exp(-8 softplus(lam)) is uniform in (0.9, 0.999) at
    r = 1, gate biases N(0, 0.1^2). With the zero conv of ``block_init``
    the recurrence carries exactly zero (silu(0) = 0); with these it
    carries signal. Float32 numpy arrays under ``block_init``'s names, one
    layer."""
    W = cfg.lru_width
    a = rng.uniform(0.9, 0.999, W)
    sp = -np.log(a) / 8.0                 # softplus(lam)
    out = dict(conv_w=rng.uniform(-0.5, 0.5, (4, W)),
               conv_b=rng.uniform(-0.5, 0.5, W),
               b_a=rng.normal(0.0, 0.1, W),
               b_x=rng.normal(0.0, 0.1, W),
               lam=sp + np.log(-np.expm1(-sp)))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _layer_inputs(x, p, tp=None):
    """(pre_r, pre_i, x, lam) of the recurrence: the two gate matmuls of
    the reference's ``_gates``, in float32 (every gate weight and bias is
    cast, as the reference casts them). With ``tp`` ``x`` is the rank's
    channels and ``w_a`` / ``w_x`` its input rows: each product is
    reduce-scattered over ``model`` to the rank's channels."""
    f32 = torch.float32
    xf = x.to(f32)
    pre = [xf @ p[w].to(f32) for w in ("w_a", "w_x")]
    if tp is not None:
        pre = [tp.scatter_sum(t, -1) for t in pre]
    return (pre[0] + p["b_a"].to(f32), pre[1] + p["b_x"].to(f32), xf,
            p["lam"].to(f32))


def _gates(x, p, tp=None):
    """(a, gated input) of the recurrence, both [B, S, W] float32."""
    return rglru_gates(*_layer_inputs(x, p, tp))


def _from(a, bx, h0):
    """The recurrence over gates (a, bx) [B, S, W] from the state ``h0``
    [B, W], folded in as a virtual step 0 (a = 1, bx = h0), as the
    reference does: ``ops.rglru_scan`` of S + 1 steps, the first
    dropped."""
    a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    bx = torch.cat([h0.to(torch.float32)[:, None], bx], dim=1)
    return ops.rglru_scan(a, bx)[:, 1:]


def rglru_scan(x, p, h0=None, tp=None, cp=None):
    """x: [B, S, W] -> (y in x's dtype, h_final [B, W] float32). Without
    ``h0`` it is the fused layer (``ops.rglru_layer``: the kernel on a
    CUDA tensor, the plain version on the CPU); with it, the recurrence
    over the gates from ``h0`` (``_from``). With ``cp`` (a segment of a
    sequence) the fused layer from zero gives the segment's final state,
    the segments' exchange the state h_in that enters it
    (``sharding.segment_carry``), and y is the recurrence over the gates
    from h_in; h_final is then the state after the last segment."""
    if h0 is not None:
        h = _from(*_gates(x, p, tp), h0)
        return h.to(x.dtype), h[:, -1]
    inputs = _layer_inputs(x, p, tp)
    h = ops.rglru_layer(*inputs)
    if cp is None:
        return h.to(x.dtype), h[:, -1]
    a, bx = rglru_gates(*inputs)
    h_in, last = sharding.segment_carry(h[:, -1], torch.prod(a, dim=1), cp)
    h = _from(a, bx, h_in)
    return h.to(x.dtype), last


def rglru_step(x, p, h, tp=None):
    """x: [B, 1, W], h: [B, W] -> (y [B, 1, W], h_new in h's dtype)."""
    a, bx = _gates(x, p, tp)
    h_new = a[:, 0] * h.to(torch.float32) + bx[:, 0]
    return h_new[:, None].to(x.dtype), h_new.to(h.dtype)


def block_apply(x, p, mode="train", cache=None, layer=None):
    """Griffin recurrent block. mode: train | prefill (also returns
    dict(conv [B, 3, W], state [B, W]) in x's dtype) | decode (cache: that
    dict). ``layer(pre_r, pre_i, x, lam)``, when given, is the gate math
    and recurrence of train mode (the learned forecaster passes the plain
    version or the fused kernel wrapper); otherwise ``rglru_scan``'s.
    Tensor-parallel with a sharded step's blocks
    (``sharding.local_params``; the forecaster's ``layer`` path runs
    without a mesh)."""
    p, tp = sharding.local_params(p)
    x = sharding.sublayer_in(x, tp)
    gate = F.gelu(x @ p["in_gate"].to(x.dtype), approximate="tanh")
    u = x @ p["in_x"].to(x.dtype)
    cp = None if mode == "decode" else sharding.context_parallel()
    conv = _causal_conv if cp is None else segment_conv
    u, conv_state = conv(u, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                         cache["conv"] if mode == "decode" else cp)
    new_cache = None
    if mode == "decode":
        y, h = rglru_step(u, p, cache["state"], tp)
        new_cache = dict(conv=conv_state, state=h)
    elif layer is not None:
        y = layer(*_layer_inputs(u, p, tp)).to(u.dtype)
    else:
        y, h = rglru_scan(u, p, tp=tp, cp=cp)
        if mode == "prefill":
            new_cache = dict(conv=conv_state, state=h.to(x.dtype))
    out = (y * gate) @ p["out"].to(x.dtype)
    return sharding.sublayer_out(out, tp), new_cache
