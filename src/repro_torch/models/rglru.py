"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
the train path of ``repro/models/rglru.py``.

    r_t = sigmoid(W_a x_t + b_a)           recurrence gate
    i_t = sigmoid(W_x x_t + b_x)           input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block is in_x / in_gate projections -> conv1d(4) -> RG-LRU -> gated
output projection. The RG-LRU after its two gate matmuls is a ``layer(pre_r,
pre_i, x, lam)``: by default the plain gate math and sequential loop of
``kernels/rglru_scan/ref.py`` (the reference uses an associative scan;
both compute the same recurrence), or the fused kernel wrapper
``kernels.rglru_scan.ops.rglru_layer``. Decode and prefill wait for the LM
stack.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ref import rglru_gates, rglru_layer_ref
from repro_torch.models.common import dense_init, zeros_init
from repro_torch.models.ssm import _causal_conv


def block_init(gen: torch.Generator, d_model: int, *, lru_width: int,
               d_conv: int = 4) -> dict:
    """The reference's parameter tree and layouts; the random draws come
    from ``gen`` in the order in_x, in_gate, w_a, w_x, out."""
    return dict(
        in_x=dense_init(gen, (d_model, lru_width)),
        in_gate=dense_init(gen, (d_model, lru_width)),
        conv_w=zeros_init((d_conv, lru_width)),
        conv_b=zeros_init((lru_width,)),
        w_a=dense_init(gen, (lru_width, lru_width), fan_in=lru_width),
        b_a=zeros_init((lru_width,)),
        w_x=dense_init(gen, (lru_width, lru_width), fan_in=lru_width),
        b_x=zeros_init((lru_width,)),
        lam=zeros_init((lru_width,)),
        out=dense_init(gen, (lru_width, d_model), fan_in=lru_width),
    )


def _layer_inputs(x, p):
    """(pre_r, pre_i, x, lam) of the recurrence: the two gate matmuls of
    the reference's ``_gates``, in float32."""
    xf = x.to(torch.float32)
    return xf @ p["w_a"] + p["b_a"], xf @ p["w_x"] + p["b_x"], xf, p["lam"]


def _gates(x, p):
    """(a, gated input) of the recurrence, both [B, S, W] float32."""
    return rglru_gates(*_layer_inputs(x, p))


def block_apply(x, p, layer=rglru_layer_ref):
    """Griffin recurrent block, train mode. ``layer(pre_r, pre_i, x, lam)``
    is the gate math and the linear recurrence: the plain version by
    default, the fused kernel wrapper when the learned forecaster passes
    it; everything around it is the same."""
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")
    u = x @ p["in_x"]
    u, _ = _causal_conv(u, p["conv_w"], p["conv_b"])
    y = layer(*_layer_inputs(u, p)).to(u.dtype)
    return (y * gate) @ p["out"]
