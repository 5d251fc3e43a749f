"""The depthwise causal conv of ``repro/models/ssm.py`` (train path only;
the Mamba-2 block waits for the LM stack)."""
from __future__ import annotations

import torch.nn.functional as F


def _causal_conv(u, w, b):
    """Depthwise causal conv, width d_conv, then SiLU. u: [B, S, C];
    w: [d_conv, C]; b: [C]. Taps are summed in the reference's order."""
    d_conv = w.shape[0]
    S = u.shape[1]
    u_pad = F.pad(u, (0, 0, d_conv - 1, 0))
    y = sum(u_pad[:, i:i + S, :] * w[i] for i in range(d_conv))
    return F.silu(y + b)
