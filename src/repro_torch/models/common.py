"""Shared model building blocks — the parts of ``repro/models/common.py``
the learned forecaster needs: fan-in-scaled truncated-normal init, zero
init, and RMS norm.

Parameters are plain tensors in the reference's layouts (a dense weight is
``[in, out]`` and applied as ``x @ W``). ``jax.random`` cannot be
reproduced, so inits draw from a seeded ``torch.Generator`` on the CPU and
are then moved to the target device: the same seed gives the same
parameters on the card and on the CPU.
"""
from __future__ import annotations

import math

import torch


def trunc_normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2] (the
    reference's ``trunc_normal``), drawn on the CPU from ``gen`` by inverse
    CDF, in float32."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (scale * x.clamp(-2.0, 2.0)).to(torch.float32)


def dense_init(gen: torch.Generator, shape, fan_in=None) -> torch.Tensor:
    """Fan-in-scaled init (the MaxText default)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return trunc_normal(gen, shape, 1.0 / math.sqrt(fan_in))


def zeros_init(shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32)


def rms_norm(x, scale, eps=1e-6):
    """RMS norm with the reference's ``(1 + scale)`` gain (zero-init scale
    is the identity gain)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)
