"""Learned telemetry forecaster: an RG-LRU sequence head with quantile
outputs, trained on sliding telemetry windows — the port of
``repro/forecast/learned.py``.

The recurrent core is the Griffin recurrent block
(``repro_torch.models.rglru``: conv1d -> RG-LRU -> gated output projection),
the optimizer is ``repro_torch.optim.adamw``, checkpoints go through
``repro_torch.checkpoint.store`` in the reference's format, and the gate
math with the linear recurrence runs through the hand-written fused CUDA
kernels (``repro_torch.kernels.rglru_scan``) in both training and
inference.

Model shape
-----------
Each history column (one region x signal series) is an independent
univariate sample: the network reads a normalized window of the last
``window`` hours and emits, for each of the next ``horizon`` hours, three
quantile *residuals* (q10 / q50 / q90) on top of the seasonal-naive
continuation of the window. The output head is zero-initialized, so an
untrained forecaster is exactly seasonal-naive.

The scan (``scan_impl``)
------------------------
  ``kernel``  ``kernels.rglru_scan.ops.rglru_layer``: the fused CUDA
              kernels (gate math and recurrence), one launch forward and
              one backward, on a CUDA device (the plain version on CPU
              tensors). The default on a CUDA device.
  ``torch``   the plain gate math and sequential recurrence
              (``kernels/rglru_scan/ref.py``), differentiated by autograd — the twin of the reference's
              default ``assoc``. The default on the CPU; a CUDA device
              takes only ``kernel``, so the plain version never runs on
              the card's main path.

A reference manifest's ``scan_impl`` is not carried across: ``pallas``
maps to ``kernel`` and ``assoc`` to the device's default (the port's own
``kernel`` and ``torch`` map the same way), since the choice belongs to the
device the checkpoint is loaded on, not to the parameters.

Parameters are a nested dict of float32 tensors with the reference's tree
names and layouts (a dense weight is ``[in, out]``). ``jax.random`` cannot
be reproduced: ``init_params`` draws from a seeded ``torch.Generator``, so
for the same seed the port's forecasts differ from the reference's (the
deterministic parts — zero head, identity conv tap, the q10/q90 biases —
are exact). ``repro_torch.convert.learned_params_from_reference`` carries
the reference's parameters across.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.checkpoint import store
from repro_torch.forecast import base
from repro_torch.kernels.rglru_scan.ops import rglru_layer as kernel_layer
from repro_torch.kernels.rglru_scan.ref import rglru_layer_ref
from repro_torch.models import common, rglru
from repro_torch.optim import adamw as _adamw
from repro_torch.optim import cosine_schedule
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime import platform

#: Quantile levels of the three output heads (the middle one is the point
#: forecast; the outer pair matches the 10/90 band every forecaster emits).
TRAIN_QUANTILES = (0.1, 0.5, 0.9)

#: Columns are padded to a multiple of this for the inference pass, as in
#: the reference (there it bounds the compiled shapes).
COLUMN_BUCKET = 8

SCAN_IMPLS = ("kernel", "torch")

_D_CONV = 4


def scan_impl_default(dev: torch.device) -> str:
    """``kernel`` on a CUDA device, ``torch`` elsewhere."""
    return "kernel" if dev.type == "cuda" else "torch"


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------

def init_params(seed: int, d_model: int, horizon: int, device=None) -> dict:
    """Parameter tree: 2-feature embed -> Griffin recurrent block ->
    quantile head, on ``device`` (drawn on the CPU from ``seed``). The head
    is zero-initialized (output = seasonal-naive residual 0) and the causal
    conv starts as the identity tap. The head reads ``[h_T | a_T]`` — final
    recurrent state plus the final seasonal anomaly."""
    gen = torch.Generator().manual_seed(int(seed))
    n_out = horizon * len(TRAIN_QUANTILES)
    tree = dict(
        inp=common.dense_init(gen, (2, d_model), ("embed", "mlp"),
                              fan_in=2),
        inp_b=common.zeros_init((d_model,), ("mlp",)),
        block=rglru.block_init(gen, d_model, lru_width=d_model,
                               d_conv=_D_CONV),
        norm=common.zeros_init((d_model,), ("embed_nosplit",)),
        head=common.zeros_init((d_model + 1, n_out), ("mlp", "embed")),
        head_b=common.zeros_init((n_out,), ("embed",)),
    )
    params, _ = common.split_tree(tree)
    params["block"]["conv_w"][-1] = 1.0
    # Outer-quantile biases start at -+0.25 sigma so the untrained band has
    # width (the q50 point forecast stays exactly seasonal-naive).
    hb = params["head_b"].view(horizon, len(TRAIN_QUANTILES))
    hb[:, 0] = -0.25
    hb[:, -1] = 0.25
    return tree_map(lambda t: t.to(device), params)


def _recurrent_block(x, p, scan_impl: str):
    """Griffin recurrent block; ``kernel`` swaps only the gate math and the
    recurrence for the fused ``repro_torch.kernels.rglru_scan`` kernels,
    keeping everything around them identical."""
    layer = kernel_layer if scan_impl == "kernel" else rglru_layer_ref
    return rglru.block_apply(x, p, layer=layer)[0]


def _quantiles_from_windows(params, xw, horizon: int, period: int,
                            scan_impl: str):
    """xw: [B, L] normalized windows -> [B, horizon, Q] quantile forecasts
    = seasonal-naive continuation of each window + learned residuals.
    Per-step features: the value and its lag-period anomaly (zero over the
    first period)."""
    B, L = xw.shape
    anom = torch.cat([torch.zeros((B, period), dtype=xw.dtype,
                                  device=xw.device),
                      xw[:, period:] - xw[:, :-period]], dim=1)
    feats = torch.stack([xw, anom], dim=-1)                     # [B, L, 2]
    h = feats @ params["inp"] + params["inp_b"]                 # [B, L, D]
    h = h + _recurrent_block(h, params["block"], scan_impl)
    h = common.rms_norm(h, params["norm"])
    head_in = torch.cat([h[:, -1], anom[:, -1:]], dim=-1)
    out = head_in @ params["head"] + params["head_b"]
    deltas = out.reshape(B, horizon, len(TRAIN_QUANTILES))
    idx = (L - period) + (torch.arange(horizon, device=xw.device) % period)
    base_rows = xw[:, idx]                                      # [B, H]
    return base_rows[..., None] + deltas


def _pinball(q, y):
    """Mean pinball loss of the three quantile heads. q: [B, H, Q],
    y: [B, H]."""
    levels = torch.tensor(TRAIN_QUANTILES, dtype=torch.float32,
                          device=q.device)
    d = y[..., None] - q
    return torch.mean(torch.maximum(levels * d, (levels - 1.0) * d))


def _train_step(opt, params, state, xb, yb, horizon: int, period: int,
                scan_impl: str):
    """One AdamW step on a batch: (new params, new state, loss before the
    step)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = _pinball(_quantiles_from_windows(live, xb, horizon, period,
                                            scan_impl), yb)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    new_params, new_state, _ = opt.update(tree_unflatten(live, grads),
                                          state, params)
    return new_params, new_state, loss.detach()


@torch.no_grad()
def _eval_loss(params, xb, yb, horizon: int, period: int, scan_impl: str):
    return _pinball(_quantiles_from_windows(params, xb, horizon, period,
                                            scan_impl), yb)


# ---------------------------------------------------------------------------
# The forecaster
# ---------------------------------------------------------------------------

@base.register_model
class LearnedForecaster(base.Forecaster):
    """RG-LRU sequence head over sliding telemetry windows with quantile
    outputs (residual over seasonal-naive; zero-init == seasonal-naive)."""

    name = "learned"
    description = ("RG-LRU (Griffin) sequence head with q10/q50/q90 "
                   "outputs, trained on sliding telemetry windows as a "
                   "residual over seasonal-naive")
    on_device = True

    def __init__(self, period: int = 24, window: int = 48,
                 horizon: int = 24, d_model: int = 16,
                 train_steps: int = 300, batch: int = 64,
                 lr: float = 1e-3, weight_decay: float = 0.1,
                 retrain_every: int = 24, seed: int = 0,
                 scan_impl: Optional[str] = None, checkpoint: str = "",
                 device=None):
        """Args as the reference's, plus ``device`` (None: the CUDA card).
        ``scan_impl`` is ``kernel`` or ``torch`` (None: the device's
        default; ``torch`` raises on a CUDA device)."""
        if window < period:
            raise ValueError(f"window ({window}) must cover at least one "
                             f"period ({period})")
        self.device = platform.device(device)
        self.period = int(period)
        self.window = int(window)
        self.horizon = int(horizon)
        self.d_model = int(d_model)
        self.train_steps = int(train_steps)
        self.batch = int(batch)
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.retrain_every = int(retrain_every)
        self.seed = int(seed)
        self.scan_impl = self._resolve_scan(scan_impl)
        self._params = None
        self._mu: Optional[np.ndarray] = None
        self._sd: Optional[np.ndarray] = None
        self._fallback: Optional[base.Forecaster] = None
        self._fits_since_train = 0
        self.train_count = 0          # full training runs so far
        self.train_seconds = 0.0      # wall time spent training
        self.last_loss = float("nan")
        self.best_step = -1           # validation snapshot kept (-1: init)
        self.best_val_loss = float("nan")
        if checkpoint:
            self._restore(checkpoint)

    def _resolve_scan(self, scan_impl: Optional[str]) -> str:
        impl = scan_impl or scan_impl_default(self.device)
        if impl not in SCAN_IMPLS:
            raise ValueError(f"scan_impl must be one of {SCAN_IMPLS}, got "
                             f"{impl!r}")
        if self.device.type == "cuda" and impl != "kernel":
            raise ValueError(f"scan_impl {impl!r} runs on the CPU only; a "
                             "CUDA device takes 'kernel'")
        return impl

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    # -- fit / update --------------------------------------------------------

    def fit(self, history: np.ndarray) -> "LearnedForecaster":
        """Walk-forward entry point: trains on the first call (and again
        every ``retrain_every`` fits), then conditions on the tail window."""
        return self._ingest(np.asarray(history, np.float64),
                            allow_train=True)

    def update(self, history: np.ndarray) -> "LearnedForecaster":
        """Cheap walk-forward refresh: re-condition on the new tail without
        retraining (trains only if no trained parameters exist yet)."""
        return self._ingest(np.asarray(history, np.float64),
                            allow_train=False)

    def _ingest(self, y: np.ndarray, allow_train: bool) -> "LearnedForecaster":
        assert y.ndim == 2 and y.shape[0] >= 1
        self._T = y.shape[0]
        self._last = y[-1].copy()
        can_condition = self._T >= max(self.window, self.period + 1)
        can_train = self._T >= self.window + self.horizon + 4
        wrong_cols = (self._params is not None
                      and y.shape[1] != self._mu.shape[0])
        if self._params is None or wrong_cols:
            if not can_train:
                obs.warn("forecast.fallback_seasonal_naive",
                         f"history of {self._T} hours is below the "
                         f"{self.window + self.horizon + 4}-hour training "
                         "minimum; serving seasonal-naive instead")
                self._fallback = base.SeasonalNaive(self.period).fit(y)
                return self
            self._train(y)
        elif allow_train:
            # Only fit() calls advance the retrain cadence — update() is
            # documented to never retrain and never count toward it.
            self._fits_since_train += 1
            if (can_train and self.retrain_every > 0
                    and self._fits_since_train >= self.retrain_every):
                self._train(y)
        if not can_condition:
            self._fallback = base.SeasonalNaive(self.period).fit(y)
            return self
        self._fallback = None
        self._condition(y)
        return self

    # -- training ------------------------------------------------------------

    def _train(self, y: np.ndarray) -> None:
        with obs.timed("forecast.fit", hours=int(y.shape[0]),
                       columns=int(y.shape[1]),
                       train_steps=self.train_steps) as t:
            self._train_impl(y)
            t.set(loss=self.last_loss)
        self.train_seconds += t.elapsed_s

    def _train_impl(self, y: np.ndarray) -> None:
        self._mu = y.mean(axis=0)
        self._sd = np.maximum(y.std(axis=0), 1e-9)
        z = (y - self._mu) / self._sd                           # [T, C]
        L, H = self.window, self.horizon
        n_origins = z.shape[0] - L - H + 1
        X = np.stack([z[o:o + L] for o in range(n_origins)])    # [n, L, C]
        Y = np.stack([z[o + L:o + L + H] for o in range(n_origins)])
        # Hold out the most recent ~20% of window origins (all columns) as
        # a validation fold: the kept parameters are the best-on-val
        # snapshot of the trajectory, the seasonal-naive init included.
        n_val = int(round(0.2 * n_origins)) if n_origins >= 5 else 0
        n_tr = n_origins - n_val

        def flat(a):
            return np.ascontiguousarray(
                a.transpose(0, 2, 1)).reshape(-1, a.shape[1])

        Xtr, Ytr = flat(X[:n_tr]), flat(Y[:n_tr])
        params = init_params(self.seed, self.d_model, H, self.device)
        opt = _adamw(
            lr=cosine_schedule(self.lr, max(self.train_steps // 10, 1),
                               max(self.train_steps, 1)),
            weight_decay=self.weight_decay)
        state = opt.init(params)
        rng = np.random.default_rng(self.seed)
        N = Xtr.shape[0]
        B = min(self.batch, N)
        shape = (H, self.period, self.scan_impl)
        if n_val:
            Xva, Yva = self._tensor(flat(X[n_tr:])), self._tensor(flat(Y[n_tr:]))
            best = (float(_eval_loss(params, Xva, Yva, *shape)), params, -1)
        loss = torch.tensor(float("nan"))
        eval_every = 10
        for s in range(self.train_steps):
            idx = rng.integers(0, N, size=B)
            params, state, loss = _train_step(
                opt, params, state, self._tensor(Xtr[idx]),
                self._tensor(Ytr[idx]), *shape)
            if n_val and (s % eval_every == eval_every - 1
                          or s == self.train_steps - 1):
                v = float(_eval_loss(params, Xva, Yva, *shape))
                if v < best[0]:
                    best = (v, params, s)
        if n_val:
            self.best_val_loss, self._params, self.best_step = best
        else:
            self._params = params
        self.last_loss = float(loss)
        self._fits_since_train = 0
        self.train_count += 1

    # -- conditioning + prediction -------------------------------------------

    def _condition(self, y: np.ndarray) -> None:
        """Run the column-batched inference pass on the tail window; caches
        the denormalized [H, C, Q] quantile tensor."""
        with obs.span("forecast.infer", columns=int(y.shape[1])):
            z = (y[-self.window:] - self._mu) / self._sd
            xw = np.ascontiguousarray(z.T)                      # [C, L]
            C = xw.shape[0]
            Cp = -(-C // COLUMN_BUCKET) * COLUMN_BUCKET
            if Cp > C:
                xw = np.vstack([xw, np.zeros((Cp - C, self.window))])
            with torch.no_grad():
                q = _quantiles_from_windows(self._params, self._tensor(xw),
                                            self.horizon, self.period,
                                            self.scan_impl)
            q = q.cpu().numpy().astype(np.float64)[:C]          # [C, H, Q]
        q = np.sort(q, axis=-1)        # enforce q10 <= q50 <= q90 pointwise
        q = q.transpose(1, 0, 2)                                # [H, C, Q]
        self._q = q * self._sd[None, :, None] + self._mu[None, :, None]

    def predict(self, horizon: int) -> base.Forecast:
        if self._fallback is not None:
            return self._fallback.predict(horizon)
        q = self._q
        H = q.shape[0]
        if horizon > H:
            extra = np.arange(H, horizon)
            if H >= self.period:      # extend periodically from the tail
                idx = H - self.period + (extra - H) % self.period
            else:                     # degenerate config: hold the last row
                idx = np.full(extra.shape, H - 1)
            q = np.concatenate([q, q[idx]], axis=0)
        q = q[:horizon]
        return base.Forecast(self._T - 1, q[..., 1], q[..., 0], q[..., 2],
                             self._last.copy())

    # -- checkpointing -------------------------------------------------------

    def save(self, directory: str, step: int = 0) -> str:
        """Persist the trained parameters + normalization in the
        reference's checkpoint format; the manifest carries the model
        config so :meth:`load` reconstructs without arguments."""
        if self._params is None:
            raise ValueError("nothing to save: forecaster has not trained")
        tree = dict(params=self._params, mu=np.asarray(self._mu),
                    sd=np.asarray(self._sd))
        extra = dict(kind="learned-forecaster", config=self._config())
        return store.save_checkpoint(directory, step, tree, extra)

    def _config(self) -> dict:
        return dict(period=self.period, window=self.window,
                    horizon=self.horizon, d_model=self.d_model,
                    scan_impl=self.scan_impl,
                    n_columns=int(self._mu.shape[0]))

    def _restore(self, directory: str, step: Optional[int] = None) -> None:
        step = store.latest_step(directory) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory!r}")
        with open(os.path.join(directory, f"step-{step}",
                               "manifest.json")) as f:
            cfg = json.load(f)["config"]
        n_cols = cfg.pop("n_columns")
        saved_scan = cfg.pop("scan_impl", None)
        for k, v in cfg.items():
            setattr(self, k, v)
        self.scan_impl = self._resolve_scan(
            "kernel" if saved_scan in ("pallas", "kernel") else None)
        target = dict(params=init_params(0, self.d_model, self.horizon),
                      mu=np.zeros(n_cols), sd=np.ones(n_cols))
        tree = store.restore_checkpoint(directory, step, target)
        self._params = tree_map(self._tensor, tree["params"])
        self._mu = np.asarray(tree["mu"], np.float64)
        self._sd = np.asarray(tree["sd"], np.float64)
        self._fits_since_train = 0

    @classmethod
    def load(cls, directory: str, step: Optional[int] = None, *,
             device=None) -> "LearnedForecaster":
        """Reconstruct a trained forecaster from a :meth:`save` directory
        (config from the manifest; call ``update(history)`` to condition)."""
        f = cls(device=device)
        f._restore(directory, step)
        return f
