"""Plain PyTorch versions of the SSD scan: the counterpart of
``repro/kernels/ssd_scan/ref.py``. ``ssd_ref`` is the model's chunked form
(``models/ssm.py::ssd_chunked``), ``ssd_naive`` the sequential recurrence;
the CUDA kernel is held against both."""
from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_chunked as ssd_ref  # noqa: F401


def ssd_naive(x, dt, A, Bm, Cm):
    """O(S·N·P) sequential recurrence — ground truth for small shapes."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bf = Bm.to(torch.float32).repeat_interleave(rep, dim=2)
    Cf = Cm.to(torch.float32).repeat_interleave(rep, dim=2)
    a = torch.exp(dt.to(torch.float32) * A.to(torch.float32))    # [b,S,H]
    xdt = x.to(torch.float32) * dt.to(torch.float32)[..., None]
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state = (state * a[:, t, :, None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bf[:, t], xdt[:, t]))
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)
