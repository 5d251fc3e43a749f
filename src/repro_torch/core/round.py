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

  ``kernel``  the hand-written CUDA annealed solve
              (``repro_torch.kernels.sinkhorn``): the whole eps schedule in
              one launch, f <- g then g <- f — the order of the reference's
              Pallas path. The default on a CUDA device. On a CPU tensor the
              same schedule runs the kernel's plain loop.
  ``torch``   the eager loop of ``torch_solver`` in the reference's XLA
              order (g <- f, then f <- g). The default on the CPU, where it
              is the twin of the reference's default ``xla`` path; CPU
              tensors only (a CUDA device takes ``kernel``).

Program 2, ``fused_temporal_round``, additionally prices and masks the
forecast round's jobs x (regions x slots) grid on the device (paper Eqs
1-8 and 11 via ``core.footprint``) before the same solve; the forecast
pipeline drives it with backend ``fused``. The reference's
``SinkhornWarmStart`` (with its adaptive loop) and the batched program are
not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core import footprint, problem, solvers
from repro_torch.core.solvers import torch_solver
from repro_torch.core.solvers.torch_solver import BIG, _NEG, bucket_for
from repro_torch.kernels.sinkhorn.ops import (anneal_schedule, eps_table,
                                              sinkhorn_solve)
from repro_torch.runtime import platform

__all__ = ["fused_solve", "fused_temporal_round", "sinkhorn_impl_default"]

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
    mass (log marginal ``_NEG``). Returns (C, log_a, log_b, Cn, scale)."""
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
    return C, log_a, log_b, Cn, scale


def _sinkhorn_kernel(C, log_a, log_b, *, eps0: float, eps_min: float,
                     iters: int, anneal_stages: int):
    """eps-annealed Sinkhorn (port of the reference's ``_sinkhorn_pallas``)
    as one call: the whole schedule in one launch of the annealed kernel on
    the card, its plain loop on the CPU. Each stage's eps is the reference
    loop's Python float rounded to float32, as the iteration kernel takes
    it; the returned eps is the last stage's Python float, as there. The
    kernel updates (f <- g, then g <- f) where the ``torch`` loop updates
    (g <- f, then f <- g); both converge to the same polytope vertex as
    eps -> 0."""
    f, g = sinkhorn_solve(C, log_a, log_b,
                          eps_table(eps0, eps_min, anneal_stages), iters)
    return f, g, anneal_schedule(eps0, eps_min, anneal_stages)[-1]


def _solve_core(c_eff, mask, cap, valid, *, impl: str, eps0: float,
                eps_min: float, iters: int, anneal_stages: int):
    """prepare -> annealed Sinkhorn -> plan extraction on the device.
    Returns the (padded-row) normalized cost matrix, row-normalized plan
    and the normalization scale; the host slices off the padding."""
    C, log_a, log_b, Cn, scale = _prepare_device(c_eff, mask, cap, valid)
    if impl == "kernel":
        f, g, eps = _sinkhorn_kernel(C, log_a, log_b, eps0=eps0,
                                     eps_min=eps_min, iters=iters,
                                     anneal_stages=anneal_stages)
    else:
        f, g, eps = torch_solver._sinkhorn_log_impl(
            C, log_a, log_b, eps0, eps_min, iters, anneal_stages)
    X = torch.exp((f[:, None] + g[None, :] - C) / eps)[:Cn.shape[0]]
    X = X / torch.clamp(X.sum(dim=1, keepdim=True), min=1e-30)
    return Cn, X, scale


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
    Cn, X, _ = _solve_core(c_eff, mask, cap, valid, impl=impl, eps0=eps0,
                           eps_min=eps_min, iters=iters,
                           anneal_stages=anneal_stages)
    return Cn, X


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


# ---------------------------------------------------------------------------
# Program 2: the fused temporal round (pricing + masking + solve)
# ---------------------------------------------------------------------------

def _price_temporal(blob, rattrs, *, offsets: tuple, lam_co2: float,
                    lam_h2o: float, defer_eps: float, guard_s: float,
                    lifetime_s: float, embodied_gco2: float,
                    embodied_water_l: float):
    """Pricing + masking of the (jobs x slots x regions) grid on the
    device. Returns ``(cost, mask, cap_t, valid)`` flattened to
    ``[Mb, S*R]`` columns."""
    Mb = blob.shape[0]
    S = len(offsets)
    R = rattrs.shape[1]
    E, t = blob[:, 0, None, None], blob[:, 1, None, None]
    budget, valid = blob[:, 2], blob[:, 3] > 0.5
    signals = blob[:, 4:4 + 3 * S * R].reshape(Mb, S, 3 * R)
    latency = blob[:, 4 + 3 * S * R:4 + 3 * S * R + R]
    allowed0 = blob[:, 4 + 3 * S * R + R:]
    ci = signals[..., :R]
    ewif = signals[..., R:2 * R]
    wue = signals[..., 2 * R:]
    pue, wsf, ref_row, cap = rattrs[0], rattrs[1], rattrs[2], rattrs[3]

    co2 = footprint.total_carbon(E, ci, t, lifetime_s, embodied_gco2)
    h2o = footprint.total_water(E, pue[None, None, :], ewif, wue,
                                wsf[None, None, :], t, lifetime_s,
                                embodied_water_l)
    co2_max = torch.clamp(co2.amax(dim=(1, 2)), min=1e-9)
    h2o_max = torch.clamp(h2o.amax(dim=(1, 2)), min=1e-9)
    obj = (lam_co2 * co2 / co2_max[:, None, None]
           + lam_h2o * h2o / h2o_max[:, None, None])
    obj = obj + ref_row[None, None, :]
    steps = torch.arange(S, dtype=torch.float32, device=blob.device)
    obj = obj + defer_eps * steps[None, :, None]

    offs = torch.tensor(offsets, dtype=torch.float32, device=blob.device)
    need = offs[None, :, None] + latency[:, None, :]
    allowed = need + guard_s <= budget[:, None, None] + 1e-9
    allowed[:, 0, :] = allowed0 > 0.5

    cost = obj.reshape(Mb, S * R)
    mask = valid[:, None] & allowed.reshape(Mb, S * R)
    cap_t = cap.repeat(S)
    return cost, mask, cap_t, valid


def _temporal_program(blob, rattrs, *, impl: str,
                      eps0: float = 0.5, eps_min: float = 0.005,
                      iters: int = 60, anneal_stages: int = 6, **statics):
    """The whole forecast-driven round on the device: Eq 1/5 footprint
    pricing over the (jobs x slots x regions) grid, Eq-7 normalization,
    the lambda-mixed Eq-8 objective + per-slot deferral ramp, the Eq-11
    deadline/guard mask, and the prepare/Sinkhorn/extraction of Program 1.

    Packed inputs — everything that varies per round rides in two uploads:
      blob    [Mb, 4 + 3SR + 2R]  per-job columns:
                [E | exec_t | slack budget | row-validity    (4)
                 | ci, ewif, wue forecast rows, slot-major   (3SR)
                 | latency | slot-0 Eq-11 mask (0/1)         (2R)]
      rattrs  [4, R]              pue | wsf | lambda_ref history row |
                                  capacity
    ``statics`` are the per-pipeline constants of ``_price_temporal``.
    """
    cost, mask, cap_t, valid = _price_temporal(blob, rattrs, **statics)
    return _solve_core(cost, mask, cap_t, valid, impl=impl, eps0=eps0,
                       eps_min=eps_min, iters=iters,
                       anneal_stages=anneal_stages)


def fused_temporal_round(inst, now_s: float, ci, ewif, wue, pue, wsf,
                         slot_offsets, server, lam_co2: float,
                         lam_h2o: float, lam_ref: float = 0.0,
                         co2_ref=None, h2o_ref=None,
                         defer_eps: float = 1e-3, guard_s: float = 240.0,
                         sinkhorn_impl: Optional[str] = None,
                         eps_min: float = 0.005, device=None):
    """Price, mask, and solve one forecast round on the device: two
    uploads, one transfer back.

    Same signature family as ``forecast.planner.build_temporal_plan`` (the
    unfused path), plus the solve. Returns ``(cost, allowed, capacity,
    SolveResult)``; cost/allowed are re-derived on the host from the
    normalized costs that come back anyway (equal to the priced tensor on
    every allowed arc; forbidden arcs carry ``solvers.BIG``).
    ``device=None`` is the CUDA card; ``sinkhorn_impl`` is chosen as in
    ``fused_solve``. The reference's ``want_plan`` (offline window
    recording) and warm-started variant (``SinkhornWarmStart``) are not
    ported yet.
    """
    dev = platform.device(device)
    impl = sinkhorn_impl or sinkhorn_impl_default(dev)
    if impl not in IMPLS:
        raise ValueError(f"sinkhorn_impl {impl!r} not in {IMPLS}")
    if dev.type == "cuda" and impl != "kernel":
        raise ValueError(f"sinkhorn_impl {impl!r} runs on CPU tensors only; "
                         "a CUDA device takes 'kernel'")
    jobs = inst.jobs
    M, N = inst.shape
    S = len(slot_offsets)
    assert slot_offsets[0] == 0.0 and ci.shape == (M, S, N)
    if co2_ref is not None and h2o_ref is not None:
        ref_row = lam_ref * (lam_co2 * np.asarray(co2_ref)
                             + lam_h2o * np.asarray(h2o_ref))
    else:
        ref_row = np.zeros(N)

    cap = np.asarray(inst.capacity, np.int64)
    bucket, _ = _pad_rows(M)

    with obs.timed("solver.fused_round", jobs=M, slots=S, regions=N,
                   bucket=bucket, occupancy=(M + 1) / bucket,
                   sinkhorn_iters=torch_solver.SINKHORN_ITERS
                   * torch_solver.SINKHORN_STAGES,
                   eps0=torch_solver.SINKHORN_EPS0, eps_min=eps_min,
                   anneal_stages=torch_solver.SINKHORN_STAGES, impl=impl,
                   device=str(dev)) as t:
        # One zero-initialized padded blob, filled in place: padding rows
        # fall out as zero-mass (validity 0) rows.
        W = 4 + 3 * S * N + 2 * N
        blob = np.zeros((bucket - 1, W), np.float32)
        for i, j in enumerate(jobs):
            blob[i, 0] = j.energy_kwh
            blob[i, 1] = j.exec_time_s
            blob[i, 3] = 1.0
        blob[:M, 2] = problem.slack_budget(jobs, now_s)
        # slot-major [ci | ewif | wue] per slot — [S, 3R] blocks flattened
        blob[:M, 4:4 + 3 * S * N] = np.concatenate(
            [ci, ewif, wue], axis=2).reshape(M, 3 * S * N)
        blob[:M, 4 + 3 * S * N:4 + 3 * S * N + N] = inst.latency
        blob[:M, 4 + 3 * S * N + N:] = inst.allowed
        rattrs = np.stack([pue, wsf, ref_row, cap]).astype(np.float32)
        Cn, X, scale = _temporal_program(
            torch.from_numpy(blob).to(dev), torch.from_numpy(rattrs).to(dev),
            impl=impl, eps_min=float(eps_min),
            offsets=tuple(float(o) for o in slot_offsets),
            lam_co2=float(lam_co2), lam_h2o=float(lam_h2o),
            defer_eps=float(defer_eps), guard_s=float(guard_s),
            lifetime_s=float(server.lifetime_s),
            embodied_gco2=float(server.embodied_gco2),
            embodied_water_l=float(server.embodied_water_l))
        Cn, X = torch.stack([Cn, X]).cpu().numpy()
        Cn = np.asarray(Cn[:M], np.float64)
        X = np.asarray(X[:M], np.float64)
        scale = float(scale)
        mask = Cn < torch_solver.BIG * 0.5   # forbidden arcs are exactly BIG
        # De-normalized costs price the objective; identical to the priced
        # tensor on every allowed arc (forbidden arcs never enter objectives).
        c_eff = np.where(mask, Cn * scale, solvers.BIG)
        cap_t = np.tile(cap, S)

        if int(cap_t.sum()) < M or not mask.any(axis=1).all():
            res = _infeasible(M)
        else:
            res = torch_solver._finalize(X, Cn, c_eff, mask, cap_t,
                                         False, None, None)
            res.backend = "fused"
        t.set(status=res.status)
    res.solve_time_s = t.elapsed_s
    return c_eff, mask, cap_t, res
