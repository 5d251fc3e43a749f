"""Public wrapper for the SSD scan kernel.

``ssd_scan`` on a CUDA tensor launches the kernel (``ssd_scan.py``) and
raises on what it does not take; on a CPU tensor it takes the plain
chunked version (``ref.py``, the model's ``ssd_chunked``) with the same
chunk length. There is no other path.
"""
from __future__ import annotations

from repro_torch.kernels.ssd_scan import ssd_scan as _kernel
from repro_torch.kernels.ssd_scan.ref import ssd_ref


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=256):
    """x [b,S,H,P], dt [b,S,H], A [H], Bm/Cm [b,S,G,N] ->
    (y [b,S,H,P], final state [b,H,P,N]) in x's dtype; chunks of
    ``min(chunk, S)`` rows."""
    if x.device.type == "cuda":
        return _kernel.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cpu":
        raise ValueError(f"no SSD scan kernel for device {x.device}")
    return ssd_ref(x, dt, A, Bm, Cm, chunk=min(chunk, x.shape[1]))
