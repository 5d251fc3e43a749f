"""Public wrappers for the Sinkhorn kernels: one iteration, and the whole
annealed solve in one launch (the scheduling round's path)."""
from __future__ import annotations

import ctypes

from repro_torch.kernels.sinkhorn import sinkhorn
from repro_torch.kernels.sinkhorn.ref import (sinkhorn_iteration_ref,
                                              sinkhorn_solve_ref)


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


def anneal_schedule(eps0: float, eps_min: float, stages: int) -> list:
    """The eps of each stage as the reference's annealed loop passes it to
    the iteration: the Python double ``eps0 * decay ** s``."""
    decay = (eps_min / eps0) ** (1.0 / max(stages - 1, 1))
    return [eps0 * decay ** s for s in range(stages)]


def eps_table(eps0: float, eps_min: float, stages: int) -> list:
    """``anneal_schedule`` rounded to float32 as ctypes rounds a double for
    the iteration kernel's ``float eps`` (and as PyTorch rounds a Python
    scalar in a float32 operation): the annealed launch's table."""
    return [ctypes.c_float(e).value
            for e in anneal_schedule(eps0, eps_min, stages)]


def sinkhorn_solve(C, log_a, log_b, table, iters):
    """The annealed solve: ``iters`` iterations at each eps of ``table`` from
    f = g = 0. A CUDA tensor makes one launch of the annealed kernel (and
    raises on what it does not take); a CPU tensor takes the plain loop."""
    if C.device.type == "cuda":
        return sinkhorn.sinkhorn_solve_cuda(C, log_a, log_b, table, iters)
    if C.device.type != "cpu":
        raise ValueError(f"no Sinkhorn kernel for device {C.device}")
    return sinkhorn_solve_ref(C, log_a, log_b, table, iters)
