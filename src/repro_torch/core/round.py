"""The fused scheduling round on a torch device — solver backend ``fused``,
the port of Program 1 of ``repro/core/round.py``.

Everything between the raw per-round tensors and the (host-side, inherently
sequential) vertex rounding runs on the device with one upload and one
transfer back: soft-cost folding -> arc masking -> cost normalization ->
balanced-OT reduction -> annealed log-domain Sinkhorn -> plan extraction.

Round-trip discipline, as in the reference:

  * the round's tensors are packed into one [3, Mb, C] arc blob
    (cost | allowed | overrun) plus one [Mb, 2] row blob (tol | valid) and
    the capacity vector — three host->device copies;
  * job rows are padded on the HOST to the row buckets of
    ``torch_solver.BUCKETS``; padding rows carry zero log-domain mass and
    are exact no-ops in every Sinkhorn update;
  * only the normalized costs and the extracted plan return to the host,
    stacked into one tensor (one transfer).

The Sinkhorn inner loop (``impl``):

  ``kernel``  the hand-written CUDA iteration kernel
              (``repro_torch.kernels.sinkhorn``), f <- g then g <- f — the
              order of the reference's Pallas path. The default on a CUDA
              device. On a CPU tensor the same loop runs the kernel's plain
              version.
  ``torch``   the eager loop of ``torch_solver`` in the reference's XLA
              order (g <- f, then f <- g). The default on the CPU, where it
              is the twin of the reference's default ``xla`` path; CPU
              tensors only (a CUDA device takes ``kernel``).

The temporal program, ``SinkhornWarmStart`` and the batched program of the
reference are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core import solvers
from repro_torch.core.solvers import torch_solver
from repro_torch.core.solvers.torch_solver import BIG, _NEG, bucket_for
from repro_torch.kernels.sinkhorn.ops import sinkhorn_iteration
from repro_torch.runtime import platform

__all__ = ["fused_solve", "sinkhorn_impl_default"]

IMPLS = ("kernel", "torch")


def sinkhorn_impl_default(dev: torch.device) -> str:
    """``kernel`` on a CUDA device (the hand-written iteration kernel),
    ``torch`` elsewhere (the eager twin of the reference's XLA loop)."""
    return "kernel" if dev.type == "cuda" else "torch"


def _pad_rows(rows: int):
    """(bucket, job-row pad): job tensors are padded to ``bucket - 1`` rows
    so that [padded jobs | dummy slack row] fills the bucket exactly."""
    bucket = bucket_for(rows + 1)
    return bucket, bucket - 1 - rows


def _pad0(x, pad: int, value=0):
    """Pad job-axis tensors with ``pad`` constant rows."""
    if pad == 0:
        return x
    width = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
    return np.pad(x, width, constant_values=value)


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------

def _prepare_device(c_eff, mask, cap, valid):
    """Device equivalent of ``torch_solver._prepare``, in float32: normalize
    costs to ~unit scale, price forbidden arcs at BIG, append the balanced-OT
    dummy supply row. ``valid`` marks real job rows; padding rows get zero
    mass (log marginal ``_NEG``)."""
    N = c_eff.shape[1]
    zero = torch.zeros((), dtype=torch.float32, device=c_eff.device)
    scale = torch.clamp(torch.max(torch.where(mask, c_eff.abs(), zero)),
                        min=1e-9)
    Cn = torch.where(mask, c_eff / scale, torch.full_like(c_eff, BIG))
    C = torch.cat([Cn, torch.zeros((1, N), dtype=torch.float32,
                                   device=c_eff.device)], dim=0)
    m_true = valid.sum().to(torch.float32)
    slack = torch.clamp(cap.sum() - m_true, min=1e-9)
    total = m_true + slack
    log_a = torch.cat([
        torch.where(valid, -torch.log(total), torch.full_like(total, _NEG)),
        torch.log(slack / total)[None]])
    log_b = torch.log(torch.clamp(cap, min=1e-12) / total)
    return C, log_a, log_b, Cn


def _sinkhorn_kernel(C, log_a, log_b, *, eps0: float, eps_min: float,
                     iters: int, anneal_stages: int):
    """eps-annealed Sinkhorn with the iteration kernel as the inner loop
    (port of the reference's ``_sinkhorn_pallas``). The anneal schedule is
    unrolled in Python and eps is a Python float per stage, as there. The
    kernel updates (f <- g, then g <- f) where the ``torch`` loop updates
    (g <- f, then f <- g); both converge to the same polytope vertex as
    eps -> 0."""
    decay = (eps_min / eps0) ** (1.0 / max(anneal_stages - 1, 1))
    f = torch.zeros(C.shape[0], dtype=torch.float32, device=C.device)
    g = torch.zeros(C.shape[1], dtype=torch.float32, device=C.device)
    eps = eps0
    for s in range(anneal_stages):
        eps = eps0 * decay ** s
        for _ in range(iters):
            f, g = sinkhorn_iteration(C, f, g, log_a, log_b, eps)
    return f, g, eps


def _solve_core(c_eff, mask, cap, valid, *, impl: str, eps0: float,
                eps_min: float, iters: int, anneal_stages: int):
    """prepare -> annealed Sinkhorn -> plan extraction on the device.
    Returns the (padded-row) normalized cost matrix and row-normalized
    plan; the host slices off the padding."""
    C, log_a, log_b, Cn = _prepare_device(c_eff, mask, cap, valid)
    if impl == "kernel":
        f, g, eps = _sinkhorn_kernel(C, log_a, log_b, eps0=eps0,
                                     eps_min=eps_min, iters=iters,
                                     anneal_stages=anneal_stages)
    else:
        f, g, eps = torch_solver._sinkhorn_log_impl(
            C, log_a, log_b, eps0, eps_min, iters, anneal_stages)
    X = torch.exp((f[:, None] + g[None, :] - C) / eps)[:Cn.shape[0]]
    X = X / torch.clamp(X.sum(dim=1, keepdim=True), min=1e-30)
    return Cn, X


def _assignment_body(arcs, tolv, cap, *, soften: bool, sigma: float,
                     impl: str, eps0: float = 0.5, eps_min: float = 0.005,
                     iters: int = 60, anneal_stages: int = 6):
    """Soft-cost folding + masking + prepare + Sinkhorn + extraction (the
    device half of the ``fused`` backend).

    ``arcs`` packs [cost | allowed(0/1) | overrun] as one [3, Mb, C] upload;
    ``tolv`` packs [tol | row-validity] as [Mb, 2] — bucket-padded, with the
    true job count implied by the validity column.
    """
    cost, allowed, overrun = arcs[0], arcs[1] > 0.5, arcs[2]
    tol, valid = tolv[:, 0], tolv[:, 1] > 0.5
    if soften:
        excess = torch.clamp(overrun - tol[:, None], min=0.0)
        c_eff = cost + sigma * excess
        mask = valid[:, None] & torch.ones_like(allowed)
    else:
        c_eff = cost
        mask = valid[:, None] & allowed
    return _solve_core(c_eff, mask, cap, valid, impl=impl, eps0=eps0,
                       eps_min=eps_min, iters=iters,
                       anneal_stages=anneal_stages)


@solvers.register("fused", on_device=True)
def fused_solve(cost: np.ndarray, allowed: np.ndarray, capacity: np.ndarray,
                *, soften: bool = False,
                overrun: Optional[np.ndarray] = None,
                tol: Optional[np.ndarray] = None, sigma: float = 10.0,
                eps_min: float = 0.005,
                sinkhorn_impl: Optional[str] = None,
                device=None) -> solvers.SolveResult:
    """The ``torch`` backend with the device work fused: one upload and one
    host transfer per round. The greedy vertex rounding + exact SSP repair
    + 2-swap polish stay on the host. ``device=None`` is the CUDA card."""
    dev = platform.device(device)
    impl = sinkhorn_impl or sinkhorn_impl_default(dev)
    if impl not in IMPLS:
        raise ValueError(f"sinkhorn_impl {impl!r} not in {IMPLS}")
    if dev.type == "cuda" and impl != "kernel":
        raise ValueError(f"sinkhorn_impl {impl!r} runs on CPU tensors only; "
                         "a CUDA device takes 'kernel'")

    def run() -> solvers.SolveResult:
        M, N = cost.shape
        cap = capacity.astype(np.int64)
        if int(cap.sum()) < M or \
                not (soften or allowed.any(axis=1).all()):
            return _infeasible(M)
        _, pad = _pad_rows(M)
        arcs = np.stack([
            _pad0(cost, pad),
            _pad0(allowed.astype(np.float64), pad),
            _pad0(overrun if overrun is not None else np.zeros((M, N)),
                  pad)]).astype(np.float32)
        tolv = np.stack([
            _pad0(tol if tol is not None else np.zeros(M), pad),
            _pad0(np.ones(M), pad)], axis=1).astype(np.float32)
        Cn, X = _assignment_body(
            torch.from_numpy(arcs).to(dev), torch.from_numpy(tolv).to(dev),
            torch.from_numpy(cap.astype(np.float32)).to(dev),
            soften=bool(soften), sigma=float(sigma), impl=impl,
            eps_min=float(eps_min))
        Cn, X = torch.stack([Cn, X]).cpu().numpy()
        if obs.enabled():
            bucket = M + 1 + pad
            obs.annotate(
                bucket=bucket, pad=pad, occupancy=(M + 1) / bucket,
                sinkhorn_iters=torch_solver.SINKHORN_ITERS
                * torch_solver.SINKHORN_STAGES,
                eps0=torch_solver.SINKHORN_EPS0, eps_min=eps_min,
                anneal_stages=torch_solver.SINKHORN_STAGES, impl=impl,
                device=str(dev))
        c_eff, mask = torch_solver._effective(cost, allowed, soften, overrun,
                                              tol, sigma)
        res = torch_solver._finalize(np.asarray(X[:M], np.float64),
                                     np.asarray(Cn[:M], np.float64), c_eff,
                                     mask, cap, soften, overrun, tol)
        res.backend = "fused"
        return res
    return solvers._timed(run)


def _infeasible(M: int) -> solvers.SolveResult:
    res = torch_solver._infeasible(M)
    res.backend = "fused"
    return res
