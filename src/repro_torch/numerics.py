"""Numerics shared by the models and the kernels' plain versions."""
from __future__ import annotations

import torch


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    switch to the identity above a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))
