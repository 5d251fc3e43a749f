"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
the train path of ``repro/models/rglru.py``.

    r_t = sigmoid(W_a x_t + b_a)           recurrence gate
    i_t = sigmoid(W_x x_t + b_x)           input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block is in_x / in_gate projections -> conv1d(4) -> RG-LRU -> gated
output projection. Its plain recurrence is the sequential loop of
``kernels/rglru_scan/ref.py`` (the reference uses an associative scan;
both compute the same recurrence). Decode and prefill wait for the LM
stack.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models.common import dense_init, zeros_init
from repro_torch.models.ssm import _causal_conv

_C = 8.0  # Griffin's fixed constant


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


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    switch to the identity above a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(x, p):
    """(a, gated input) of the recurrence, both [B, S, W] float32."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"] + p["b_x"])
    log_a = -_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * xf)
    return a, gated_x


def block_apply(x, p, scan=rglru_scan_ref):
    """Griffin recurrent block, train mode. ``scan(a, bx)`` is the linear
    recurrence: the plain loop by default, the kernel wrapper when the
    learned forecaster passes it; everything around it is the same."""
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")
    u = x @ p["in_x"]
    u = _causal_conv(u, p["conv_w"], p["conv_b"])
    y = scan(*_gates(u, p)).to(u.dtype)
    return (y * gate) @ p["out"]
