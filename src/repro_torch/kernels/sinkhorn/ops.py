"""Public wrapper for the Sinkhorn-iteration kernel."""
from __future__ import annotations

from repro_torch.kernels.sinkhorn import sinkhorn
from repro_torch.kernels.sinkhorn.ref import sinkhorn_iteration_ref


def sinkhorn_iteration(C, f, g, log_a, log_b, eps):
    """One fused (f, g) Sinkhorn update, f from g then g from the new f.

    A CUDA tensor launches the kernel (and raises on what it does not take);
    a CPU tensor takes the plain version. The ``f`` argument is unused —
    the update recomputes it from g — but kept for signature parity with
    ref.py, as in the reference wrapper."""
    if C.device.type == "cuda":
        return sinkhorn.sinkhorn_iteration_cuda(C, g, log_a, log_b, eps)
    if C.device.type != "cpu":
        raise ValueError(f"no Sinkhorn kernel for device {C.device}")
    return sinkhorn_iteration_ref(C, f, g, log_a, log_b, eps)
