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

Program 1b, ``fused_round_batch``, solves many cells' assignment rounds at
once: the same device body over a leading cell axis (the reference vmaps
it), one cell-batched kernel launch per group of same-shaped requests, and
the per-cell host rounding on exactly the inputs a per-cell ``fused_solve``
would get. The device stages broadcast over that optional leading axis, so
the single-cell path is the B = 1 case of the same code. The reference's
``round.batch_compile`` counter and its power-of-two padding of the cell
axis (``_batch_size``) serve XLA's compile cache, which PyTorch has no
counterpart of: the port launches each group at its own size.

Program 2, ``fused_temporal_round``, additionally prices and masks the
forecast round's jobs x (regions x slots) grid on the device (paper Eqs
1-8 and 11 via ``core.footprint``) before the same solve; the forecast
pipeline drives it with backend ``fused``. With a ``SinkhornWarmStart``
it runs the adaptive solve instead (``_temporal_adaptive_program``): the
column potentials carried from the last round seed it, each annealing
stage exits on convergence, and on the card it is one launch of the
warm-started kernel — the live service's between-round carry.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core import footprint, problem, solvers
from repro_torch.core.solvers import torch_solver
from repro_torch.core.solvers.torch_solver import BIG, _NEG, bucket_for
from repro_torch.kernels.sinkhorn.ops import (anneal_schedule, eps_table,
                                              sinkhorn_solve,
                                              sinkhorn_solve_adaptive,
                                              sinkhorn_solve_batched)
from repro_torch.runtime import platform

__all__ = ["fused_solve", "fused_temporal_round", "fused_round_batch",
           "sinkhorn_impl_default", "SolveRequest", "group_requests",
           "SinkhornWarmStart"]

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
    mass (log marginal ``_NEG``). Every tensor may carry a leading cell
    axis ([B, Mb, N] costs, [B, N] capacities, [B, Mb] validity); each
    reduction runs within its cell. Returns (C, log_a, log_b, Cn, scale),
    ``scale`` one per cell."""
    lead, N = c_eff.shape[:-2], c_eff.shape[-1]
    zero = torch.zeros((), dtype=torch.float32, device=c_eff.device)
    scale = torch.clamp(torch.where(mask, c_eff.abs(), zero)
                        .amax(dim=(-2, -1)), min=1e-9)
    Cn = torch.where(mask, c_eff / scale[..., None, None],
                     torch.full_like(c_eff, BIG))
    C = torch.cat([Cn, torch.zeros(lead + (1, N), dtype=torch.float32,
                                   device=c_eff.device)], dim=-2)
    m_true = valid.sum(dim=-1).to(torch.float32)
    slack = torch.clamp(cap.sum(dim=-1) - m_true, min=1e-9)
    total = (m_true + slack)[..., None]
    log_a = torch.cat([
        torch.where(valid, -torch.log(total), torch.full_like(total, _NEG)),
        torch.log(slack[..., None] / total)], dim=-1)
    log_b = torch.log(torch.clamp(cap, min=1e-12) / total)
    return C, log_a, log_b, Cn, scale


def _sinkhorn_kernel(C, log_a, log_b, *, eps0: float, eps_min: float,
                     iters: int, anneal_stages: int):
    """eps-annealed Sinkhorn (port of the reference's ``_sinkhorn_pallas``)
    as one call: the whole schedule in one launch of the annealed kernel on
    the card — one cell-batched launch for a [B, M, N] C — its plain loop
    on the CPU. Each stage's eps is the reference loop's Python float
    rounded to float32, as the iteration kernel takes it; the returned eps
    is the last stage's Python float, as there. The kernel updates
    (f <- g, then g <- f) where the ``torch`` loop updates (g <- f, then
    f <- g); both converge to the same polytope vertex as eps -> 0."""
    solve = sinkhorn_solve_batched if C.dim() == 3 else sinkhorn_solve
    f, g = solve(C, log_a, log_b, eps_table(eps0, eps_min, anneal_stages),
                 iters)
    return f, g, anneal_schedule(eps0, eps_min, anneal_stages)[-1]


def _solve_core(c_eff, mask, cap, valid, *, impl: str, eps0: float,
                eps_min: float, iters: int, anneal_stages: int):
    """prepare -> annealed Sinkhorn -> plan extraction on the device, over
    an optional leading cell axis. Returns the (padded-row) normalized cost
    matrix, row-normalized plan and the normalization scale; the host
    slices off the padding."""
    C, log_a, log_b, Cn, scale = _prepare_device(c_eff, mask, cap, valid)
    if impl == "kernel":
        f, g, eps = _sinkhorn_kernel(C, log_a, log_b, eps0=eps0,
                                     eps_min=eps_min, iters=iters,
                                     anneal_stages=anneal_stages)
    else:
        f, g, eps = torch_solver._sinkhorn_log_impl(
            C, log_a, log_b, eps0, eps_min, iters, anneal_stages)
    X = torch.exp((f[..., :, None] + g[..., None, :] - C) / eps)
    X = X[..., :Cn.shape[-2], :]
    X = X / torch.clamp(X.sum(dim=-1, keepdim=True), min=1e-30)
    return Cn, X, scale


def _assignment_body(arcs, tolv, cap, *, soften: bool, sigma: float,
                     impl: str, eps0: float = 0.5, eps_min: float = 0.005,
                     iters: int = 60, anneal_stages: int = 6):
    """Soft-cost folding + masking + prepare + Sinkhorn + extraction (the
    device half of the ``fused`` backend).

    ``arcs`` packs [cost | allowed(0/1) | overrun] as one [3, Mb, C] upload;
    ``tolv`` packs [tol | row-validity] as [Mb, 2] — bucket-padded, with the
    true job count implied by the validity column. With a leading cell axis
    ([B, 3, Mb, C], [B, Mb, 2], [B, C]) it is Program 1b's body: each
    cell's results are those of the body on that cell alone.
    """
    cost, allowed, overrun = (arcs[..., 0, :, :], arcs[..., 1, :, :] > 0.5,
                              arcs[..., 2, :, :])
    tol, valid = tolv[..., 0], tolv[..., 1] > 0.5
    if soften:
        excess = torch.clamp(overrun - tol[..., None], min=0.0)
        c_eff = cost + sigma * excess
        mask = valid[..., None] & torch.ones_like(allowed)
    else:
        c_eff = cost
        mask = valid[..., None] & allowed
    Cn, X, _ = _solve_core(c_eff, mask, cap, valid, impl=impl, eps0=eps0,
                           eps_min=eps_min, iters=iters,
                           anneal_stages=anneal_stages)
    return Cn, X


def _resolve_impl(sinkhorn_impl: Optional[str], dev: torch.device) -> str:
    impl = sinkhorn_impl or sinkhorn_impl_default(dev)
    if impl not in IMPLS:
        raise ValueError(f"sinkhorn_impl {impl!r} not in {IMPLS}")
    if dev.type == "cuda" and impl != "kernel":
        raise ValueError(f"sinkhorn_impl {impl!r} runs on CPU tensors only; "
                         "a CUDA device takes 'kernel'")
    return impl


def _pack(cost, allowed, overrun, tol, pad: int):
    """One request's host blobs, bucket-padded: arcs [3, Mb, C] and tolv
    [Mb, 2], float32."""
    M, N = cost.shape
    arcs = np.stack([
        _pad0(cost, pad),
        _pad0(np.asarray(allowed).astype(np.float64), pad),
        _pad0(overrun if overrun is not None else np.zeros((M, N)),
              pad)]).astype(np.float32)
    tolv = np.stack([
        _pad0(tol if tol is not None else np.zeros(M), pad),
        _pad0(np.ones(M), pad)], axis=1).astype(np.float32)
    return arcs, tolv


def _rounded(X, Cn, cost, allowed, cap, soften, overrun, tol, sigma):
    """The host half of ``fused``: the vertex rounding of one cell's
    (real-row) plan."""
    c_eff, mask = torch_solver._effective(cost, allowed, soften, overrun,
                                          tol, sigma)
    res = torch_solver._finalize(np.asarray(X, np.float64),
                                 np.asarray(Cn, np.float64), c_eff, mask,
                                 cap, soften, overrun, tol)
    res.backend = "fused"
    return res


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
    impl = _resolve_impl(sinkhorn_impl, dev)

    def run() -> solvers.SolveResult:
        M, N = cost.shape
        cap = capacity.astype(np.int64)
        if int(cap.sum()) < M or \
                not (soften or allowed.any(axis=1).all()):
            return _infeasible(M)
        _, pad = _pad_rows(M)
        arcs, tolv = _pack(cost, allowed, overrun, tol, pad)
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
        return _rounded(X[:M], Cn[:M], cost, allowed, cap, soften, overrun,
                        tol, sigma)
    return solvers._timed(run)


def _infeasible(M: int) -> solvers.SolveResult:
    res = torch_solver._infeasible(M)
    res.backend = "fused"
    return res


# ---------------------------------------------------------------------------
# Program 1b: many cells' assignment rounds over a leading cell axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SolveRequest:
    """One cell's assignment-round solve, queued for batching
    (``fused_round_batch``). Fields mirror ``fused_solve``'s signature — a
    request is exactly one deferred call; the device travels beside the
    requests, as an argument of ``fused_round_batch``."""
    cost: np.ndarray                       # [M, C]
    allowed: np.ndarray                    # [M, C]
    capacity: np.ndarray                   # [C]
    soften: bool = False
    overrun: Optional[np.ndarray] = None
    tol: Optional[np.ndarray] = None
    sigma: float = 10.0
    eps_min: float = 0.005
    sinkhorn_impl: Optional[str] = None


def group_requests(requests) -> dict:
    """Group request *indices* by batch signature: (row bucket, columns,
    cost dtype, soften, sigma, impl, eps_min).

    Pure bookkeeping (property-tested): a group never mixes row buckets,
    column counts, dtypes, or solver statics — each group maps onto exactly
    one batched body and one cell-batched launch (or its split).
    """
    groups: dict = {}
    for i, r in enumerate(requests):
        M, C = np.asarray(r.cost).shape
        key = (bucket_for(M + 1), C, np.dtype(np.asarray(r.cost).dtype).str,
               bool(r.soften), float(r.sigma), r.sinkhorn_impl,
               float(r.eps_min))
        groups.setdefault(key, []).append(i)
    return groups


def _request_statics(req: SolveRequest, dev: torch.device) -> dict:
    """The resolved solver constants of one request on ``dev`` — identical
    across a group by construction of the group key."""
    return dict(soften=bool(req.soften), sigma=float(req.sigma),
                impl=_resolve_impl(req.sinkhorn_impl, dev),
                eps_min=float(req.eps_min))


def visible_devices(dev: torch.device) -> int:
    """The devices ``fused_round_batch`` can split a group across: every
    visible CUDA card for a CUDA device, one for the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _shard_devices(dev: torch.device, devices: int) -> list:
    """The device of each of ``devices`` shards: the named card alone, or
    cards 0 .. devices - 1 (an explicit index, so a flush from any thread
    lands where it should)."""
    if dev.type != "cuda":
        return [dev]
    if devices == 1:
        return [torch.device("cuda", dev.index if dev.index is not None
                             else torch.cuda.current_device())]
    return [torch.device("cuda", k) for k in range(devices)]


def fused_round_batch(requests, devices: int = 1, device=None) -> list:
    """Solve many independent cells' assignment rounds, one batched body
    (and one cell-batched kernel launch, or its split) per (bucket, dtype,
    statics) group instead of one launch per cell.

    The batch runs the single-cell ``fused`` body over a leading cell axis
    with identical per-cell bucket padding, so every cell's normalized
    costs and transport plan are **bitwise identical** to a per-cell
    ``fused_solve`` call (pinned in tests/test_torch_device_executor.py),
    and the host-side vertex rounding consumes identical inputs. With
    ``devices > 1`` each group is split into ``devices`` contiguous shards,
    one a card (the reference's ``shard_map`` over its cell axis; only one
    card has been proven).

    Returns ``SolveResult``s in request order; per-request infeasibility
    (capacity shortfall / fully masked row) short-circuits exactly like
    ``fused_solve``. ``obs`` counter ``round.batch_solves`` counts cells
    served. ``device=None`` is the CUDA card.
    """
    dev = platform.device(device)
    devices = max(1, int(devices))
    n_avail = visible_devices(dev)
    if devices > n_avail:
        raise ValueError(f"devices={devices} exceeds the {n_avail} "
                         f"available {dev.type} device(s)")
    results: list = [None] * len(requests)
    live: list = []
    for i, r in enumerate(requests):
        M, C = r.cost.shape
        cap = np.asarray(r.capacity).astype(np.int64)
        allowed = np.asarray(r.allowed, bool)
        if int(cap.sum()) < M or \
                not (r.soften or allowed.any(axis=1).all()):
            results[i] = _infeasible(M)
        else:
            live.append(i)
    if not live:
        return results
    groups = group_requests([requests[i] for i in live])
    shard_devs = _shard_devices(dev, devices)
    with obs.timed("solver.round_batch", requests=len(requests),
                   groups=len(groups), devices=devices) as t:
        for key, local in groups.items():
            idxs = [live[j] for j in local]
            bucket = key[0]
            statics = _request_statics(requests[idxs[0]], dev)
            arcs_l, tolv_l, cap_l = [], [], []
            for i in idxs:
                r = requests[i]
                arcs, tolv = _pack(r.cost, r.allowed, r.overrun, r.tol,
                                   bucket - 1 - r.cost.shape[0])
                arcs_l.append(arcs)
                tolv_l.append(tolv)
                cap_l.append(np.asarray(r.capacity).astype(np.int64)
                             .astype(np.float32))
            arcs, tolv, cap = (np.stack(arcs_l), np.stack(tolv_l),
                               np.stack(cap_l))
            out = []
            for part, sdev in zip(np.array_split(np.arange(len(idxs)),
                                                 len(shard_devs)),
                                  shard_devs):
                if not len(part):
                    continue
                lo, hi = int(part[0]), int(part[-1]) + 1
                # The device is per thread, and a flush runs on whichever
                # cell thread arrives last: name it for every shard.
                with (torch.cuda.device(sdev) if sdev.type == "cuda"
                      else contextlib.nullcontext()):
                    Cn, X = _assignment_body(
                        torch.from_numpy(arcs[lo:hi]).to(sdev),
                        torch.from_numpy(tolv[lo:hi]).to(sdev),
                        torch.from_numpy(cap[lo:hi]).to(sdev), **statics)
                    out.append(torch.stack([Cn, X], dim=1).cpu().numpy())
            CnX = np.concatenate(out)
            for b, i in enumerate(idxs):
                r = requests[i]
                M = r.cost.shape[0]
                results[i] = _rounded(
                    CnX[b, 1, :M], CnX[b, 0, :M],
                    np.asarray(r.cost, np.float64),
                    np.asarray(r.allowed, bool),
                    np.asarray(r.capacity).astype(np.int64), r.soften,
                    r.overrun, r.tol, r.sigma)
        obs.counter("round.batch_solves", len(live))
    per = t.elapsed_s / max(len(requests), 1)
    for r in results:
        r.solve_time_s = per
    return results


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


def _temporal_program(blob, rattrs, *, impl: str, want_plan: bool = False,
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
    Returns ``(Cn, X, scale)``, and with ``want_plan`` the priced ``cost``
    and ``mask`` too.
    """
    cost, mask, cap_t, valid = _price_temporal(blob, rattrs, **statics)
    Cn, X, scale = _solve_core(cost, mask, cap_t, valid, impl=impl,
                               eps0=eps0, eps_min=eps_min, iters=iters,
                               anneal_stages=anneal_stages)
    if want_plan:
        return Cn, X, scale, cost, mask
    return Cn, X, scale


def _temporal_adaptive_program(blob, rattrs, g0, tol: float, *, impl: str,
                               eps0: float, eps_min: float, iters: int,
                               anneal_stages: int, **statics):
    """``_temporal_program`` with the adaptive warm-startable Sinkhorn: the
    caller supplies initial column potentials ``g0`` ([S*R], zeros for a
    cold start) and gets back the converged potentials and the iterations
    run — the live-serving path that carries duals between consecutive
    rounds (``SinkhornWarmStart``). ``impl`` ``kernel`` is one launch of
    the adaptive kernel on the card (its plain loop on a CPU tensor);
    ``torch`` is ``torch_solver._sinkhorn_log_adaptive_impl``. Both run
    the float32 schedule of ``torch_solver.eps_schedule``, computed on the
    host, and extract the plan at its last eps. Returns ``(Cn, X, scale,
    g, used)``, ``used`` a 0-d int32 tensor."""
    cost, mask, cap_t, valid = _price_temporal(blob, rattrs, **statics)
    C, log_a, log_b, Cn, scale = _prepare_device(cost, mask, cap_t, valid)
    if impl == "kernel":
        table = torch_solver.eps_schedule(eps0, eps_min,
                                          anneal_stages).tolist()
        f, g, used = sinkhorn_solve_adaptive(C, log_a, log_b, g0, tol, table,
                                             iters)
        eps = table[-1]
    else:
        f, g, eps, used = torch_solver._sinkhorn_log_adaptive_impl(
            C, log_a, log_b, g0, tol, eps0, eps_min, iters, anneal_stages)
    X = torch.exp((f[:, None] + g[None, :] - C) / eps)[:Cn.shape[0]]
    X = X / torch.clamp(X.sum(dim=1, keepdim=True), min=1e-30)
    return Cn, X, scale, g, used


@dataclasses.dataclass
class SinkhornWarmStart:
    """Column-potential carry between consecutive fused temporal rounds.

    The temporal OT's column space — (region, slot) cells — is fixed per
    pipeline while the row space (jobs) changes every round, so the column
    potentials ``g`` are the part of the duals worth carrying: passed as
    the next round's ``g0``, a drifted-telemetry round converges in a
    handful of final-eps iterations instead of the full annealed schedule.
    The first round (or any column-shape change) runs cold: zeros init +
    the full schedule. Cold and warm iteration counts are recorded via
    ``repro_torch.obs`` (``solver.sinkhorn_iters_cold`` / ``_warm``) and
    kept on the object for reporting (``repro_torch.serve`` folds them
    into its report).
    """
    tol: float = torch_solver.SINKHORN_TOL
    g: Optional[np.ndarray] = None
    cold_iters: list = dataclasses.field(default_factory=list)
    warm_iters: list = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.g = None

    @property
    def mean_cold_iters(self) -> float:
        return float(np.mean(self.cold_iters)) if self.cold_iters else 0.0

    @property
    def mean_warm_iters(self) -> float:
        return float(np.mean(self.warm_iters)) if self.warm_iters else 0.0


def fused_temporal_round(inst, now_s: float, ci, ewif, wue, pue, wsf,
                         slot_offsets, server, lam_co2: float,
                         lam_h2o: float, lam_ref: float = 0.0,
                         co2_ref=None, h2o_ref=None,
                         defer_eps: float = 1e-3, guard_s: float = 240.0,
                         want_plan: bool = False,
                         sinkhorn_impl: Optional[str] = None,
                         eps_min: float = 0.005,
                         warm_start: Optional[SinkhornWarmStart] = None,
                         device=None):
    """Price, mask, and solve one forecast round on the device: two
    uploads, one transfer back.

    Same signature family as ``forecast.planner.build_temporal_plan`` (the
    unfused path), plus the solve. Returns ``(cost, allowed, capacity,
    SolveResult)``. With ``want_plan`` (offline window recording) the raw
    priced tensors come back from the device; otherwise cost/allowed are
    re-derived on the host from the normalized costs that come back anyway
    (equal to the priced tensor on every allowed arc; forbidden arcs carry
    ``solvers.BIG``). ``device=None`` is the CUDA card; ``sinkhorn_impl``
    is chosen as in ``fused_solve``.

    ``warm_start`` switches to the adaptive Sinkhorn (convergence-exit
    stages; on the card one launch of ``sinkhorn_anneal_adaptive``): the
    object's carried column potentials seed the solve — zeros + the full
    annealed schedule when empty (cold) — and the converged potentials
    plus iteration counts are written back, so consecutive calls with the
    same object warm-start each other (the ``repro_torch.serve`` decision
    loop's between-round carry). The plan, the potentials and the count
    come back in one transfer.
    """
    dev = platform.device(device)
    impl = _resolve_impl(sinkhorn_impl, dev)
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
        statics = dict(
            offsets=tuple(float(o) for o in slot_offsets),
            lam_co2=float(lam_co2), lam_h2o=float(lam_h2o),
            defer_eps=float(defer_eps), guard_s=float(guard_s),
            lifetime_s=float(server.lifetime_s),
            embodied_gco2=float(server.embodied_gco2),
            embodied_water_l=float(server.embodied_water_l))
        blob_t = torch.from_numpy(blob).to(dev)
        rattrs_t = torch.from_numpy(rattrs).to(dev)
        if warm_start is not None:
            assert not want_plan, \
                "warm_start and want_plan are mutually exclusive"
            cols = S * N
            cold = warm_start.g is None or warm_start.g.shape != (cols,)
            g0 = (np.zeros(cols, np.float32) if cold
                  else warm_start.g.astype(np.float32))
            # Cold: the full annealed schedule with per-stage early exit.
            # Warm: one final-eps stage from the carried potentials, with
            # the whole fixed budget available as the iteration cap (the
            # cap should never bind when the carry is any good).
            if cold:
                schedule = dict(eps0=torch_solver.SINKHORN_EPS0,
                                iters=torch_solver.SINKHORN_ITERS,
                                anneal_stages=torch_solver.SINKHORN_STAGES)
            else:
                schedule = dict(eps0=float(eps_min),
                                iters=torch_solver.SINKHORN_ITERS
                                * torch_solver.SINKHORN_STAGES,
                                anneal_stages=1)
            Cn_t, X_t, scale_t, g_t, used_t = _temporal_adaptive_program(
                blob_t, rattrs_t, torch.from_numpy(g0).to(dev),
                float(warm_start.tol), impl=impl, eps_min=float(eps_min),
                **schedule, **statics)
            # One transfer: [Cn | X | scale | iterations | g].
            host = torch.cat([torch.stack([Cn_t, X_t]).reshape(-1),
                              scale_t.reshape(1),
                              used_t.to(torch.float32).reshape(1),
                              g_t]).cpu().numpy()
            Mb = Cn_t.shape[0]
            Cn, X = host[:2 * Mb * cols].reshape(2, Mb, cols)
            scale = float(host[2 * Mb * cols])
            used = int(host[2 * Mb * cols + 1])
            warm_start.g = host[2 * Mb * cols + 2:].copy()
            (warm_start.cold_iters if cold
             else warm_start.warm_iters).append(used)
            obs.observe("solver.sinkhorn_iters_cold" if cold
                        else "solver.sinkhorn_iters_warm", float(used))
            t.set(warm=not cold, adaptive_iters=used)
        else:
            out = _temporal_program(blob_t, rattrs_t, impl=impl,
                                    want_plan=bool(want_plan),
                                    eps_min=float(eps_min), **statics)
            Cn, X = torch.stack(out[:2]).cpu().numpy()
            scale = float(out[2])
        Cn = np.asarray(Cn[:M], np.float64)
        X = np.asarray(X[:M], np.float64)
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
    if want_plan:
        cost = np.asarray(out[3][:M].cpu().numpy(), np.float64)
        allowed = out[4][:M].cpu().numpy()
        return cost, allowed, cap_t, res
    return c_eff, mask, cap_t, res
