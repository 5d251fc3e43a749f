"""The port's forecasters, optimizer and checkpoint store against the JAX
package on the same inputs: Holt-Winters (grid choice and forecasts), the
learned RG-LRU forecaster (quantiles, one training step, a 3-step fit,
checkpoints in both directions), AdamW, the registry and backtesting.

``jax.random`` cannot be reproduced, so the learned-forecaster tests
replace the port's ``init_params`` (here only) with the JAX init carried
across by ``convert.learned_params_from_reference``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forecast as ref_forecast
from repro.core import telemetry as ref_telemetry
from repro.forecast import holtwinters as ref_hw
from repro.forecast import learned as ref_learned
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine
from repro_torch import convert
from repro_torch import forecast
from repro_torch.forecast import holtwinters, learned
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.optim.adamw import tree_leaves, tree_map

# Learned forecaster: float32 matmuls and reductions in two libraries.
QUANT_ATOL = 1e-5
# The 3-step fit's loss: the reference pins its two scans at rel 1e-5.
LOSS_RTOL = 1e-5
# Forecasts in original units (ci ~ 50-800): float32 filters/networks whose
# operations round differently (XLA on the CPU contracts a*b+c into one
# FMA, PyTorch rounds twice), so relative 1e-5.
FC_RTOL = 1e-5


@pytest.fixture(scope="module")
def tele():
    return ref_telemetry.generate(days=6, seed=0)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's learned forecaster initialised with the reference's JAX
    parameters for the same seed."""
    def init(seed, d_model, horizon, device=None):
        tree = ref_learned.init_params(jax.random.PRNGKey(seed), d_model,
                                       horizon)
        return convert.learned_params_from_reference(
            jax.tree.map(np.asarray, tree), device or "cpu")
    monkeypatch.setattr(learned, "init_params", init)


def _port_learned(**kw):
    return forecast.make_forecaster("learned", device="cpu", **kw)


# ---------------------------------------------------------------------------
# Holt-Winters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hw_series():
    """16 days of the pricer's stacked [ci | ewif | wue] history (15
    columns), long enough for the largest fit bucket."""
    t = ref_telemetry.generate(days=16, seed=0)
    return np.concatenate([t.ci, t.ewif, t.wue], axis=1)


def _grid_choices(monkeypatch):
    """Record the per-column grid index each side's filter picks."""
    seen = {}
    ref_filter, port_filter = ref_hw._hw_filter, holtwinters._hw_filter

    def ref_spy(*a, **kw):
        out = ref_filter(*a, **kw)
        seen["ref"] = np.argmin(np.asarray(out[3]), axis=0)
        return out

    def port_spy(*a, **kw):
        out = port_filter(*a, **kw)
        seen["port"] = np.argmin(out[3].numpy(), axis=0)
        return out
    monkeypatch.setattr(ref_hw, "_hw_filter", ref_spy)
    monkeypatch.setattr(holtwinters, "_hw_filter", port_spy)
    return seen


@pytest.mark.parametrize("hours", [
    10, 30,                                     # persistence / seasonal fb
    48, 60, 72, 90, 96, 130, 144, 190, 192, 250, 288, 300, 336, 380])
def test_holtwinters_matches_reference(hw_series, monkeypatch, hours):
    """Every fit bucket (2..14 periods, clipped beyond) and both fallbacks:
    the same grid triple per column, and forecasts/bands within FC_RTOL."""
    seen = _grid_choices(monkeypatch)
    y = hw_series[:hours]
    ref = ref_forecast.make_forecaster("holtwinters").fit(y)
    port = forecast.make_forecaster("holtwinters", device="cpu").fit(y)
    if hours >= 48:
        np.testing.assert_array_equal(seen["port"], seen["ref"])
    else:
        assert not seen
    fr, fp = ref.predict(30), port.predict(30)
    assert fr.issue_hour == fp.issue_hour
    # A band edge is mean -+ spread and may cancel toward 0: held to
    # FC_RTOL of its column's scale.
    scale = FC_RTOL * np.abs(fr.mean).max(axis=0)
    for k in ("mean", "lo", "hi", "anchor"):
        a, b = getattr(fp, k), getattr(fr, k)
        assert np.all(np.abs(a - b) <= FC_RTOL * np.abs(b) + scale), k


def test_holtwinters_buckets_match_reference():
    assert holtwinters.FIT_BUCKET_PERIODS == ref_hw.FIT_BUCKET_PERIODS
    np.testing.assert_array_equal(holtwinters.PARAM_GRID, ref_hw.PARAM_GRID)
    for rows in (1, 24, 48, 49, 100, 335, 336, 400):
        assert holtwinters.fit_bucket_for(rows, 24) == \
            ref_hw.fit_bucket_for(rows, 24)
    np.testing.assert_array_equal(holtwinters.damped_sum(30),
                                  ref_hw.damped_sum(30))


# ---------------------------------------------------------------------------
# The learned forecaster
# ---------------------------------------------------------------------------

def test_init_params_deterministic_parts():
    """The port's own init: the reference's tree names and shapes, the
    exact deterministic parts, and one draw per seed."""
    p = learned.init_params(0, 16, 24)
    r = jax.tree.map(np.asarray, ref_learned.init_params(
        jax.random.PRNGKey(0), 16, 24))
    assert jax.tree.structure(r) == jax.tree.structure(
        tree_map(lambda t: t.numpy(), p))
    for a, b in zip(tree_leaves(p), jax.tree.leaves(r)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    for k in ("head", "inp_b", "norm"):
        assert not p[k].any()
    np.testing.assert_array_equal(p["head_b"].numpy(), r["head_b"])
    np.testing.assert_array_equal(p["block"]["conv_w"].numpy(),
                                  r["block"]["conv_w"])
    assert float(p["inp"].abs().max()) <= 2.0 / np.sqrt(2.0)
    again = learned.init_params(0, 16, 24)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))
    assert not torch.equal(p["inp"], learned.init_params(1, 16, 24)["inp"])


@pytest.fixture(scope="module")
def trained_ref_params(tele):
    """The reference forecaster's parameters after 20 training steps."""
    f = ref_forecast.make_forecaster("learned", train_steps=20, seed=0)
    f.fit(tele.ci[:120])
    return jax.tree.map(np.asarray, f._params)


@pytest.mark.parametrize("scan_impl", ["torch", "kernel"])
def test_quantiles_from_windows_match_reference(trained_ref_params,
                                                scan_impl):
    """[16, 48] windows through trained parameters: the reference's assoc
    scan vs the port's plain loop, and its Pallas kernel (interpret) vs the
    port's kernel wrapper (plain version on CPU tensors)."""
    ref_params = trained_ref_params
    xw = np.random.default_rng(0).standard_normal((16, 48)).astype(
        np.float32)
    ref_impl = "pallas" if scan_impl == "kernel" else "assoc"
    q_ref = np.asarray(ref_learned._quantiles_from_windows(
        ref_params, jnp.asarray(xw), 24, 24, ref_impl))
    q = learned._quantiles_from_windows(
        convert.learned_params_from_reference(ref_params),
        torch.from_numpy(xw), 24, 24, scan_impl)
    np.testing.assert_allclose(q.detach().numpy(), q_ref, atol=QUANT_ATOL)


def test_train_step_matches_reference(trained_ref_params):
    """One AdamW step from trained parameters on the same batch: loss,
    gradients and new parameters."""
    ref_params = trained_ref_params
    rng = np.random.default_rng(1)
    xb = rng.standard_normal((64, 48)).astype(np.float32)
    yb = rng.standard_normal((64, 24)).astype(np.float32)
    opt_r, step_r, _ = ref_learned._train_step(24, 24, "assoc", 1e-3, 0.1,
                                               300)
    state_r = opt_r.init(ref_params)
    loss_fn = lambda p: ref_learned._pinball(
        ref_learned._quantiles_from_windows(p, jnp.asarray(xb), 24, 24,
                                            "assoc"), jnp.asarray(yb))
    grads_r = jax.grad(loss_fn)(ref_params)
    new_r, _, loss_r = step_r(ref_params, state_r, jnp.asarray(xb),
                              jnp.asarray(yb))

    params = convert.learned_params_from_reference(ref_params)
    opt = adamw(lr=cosine_schedule(1e-3, 30, 300), weight_decay=0.1)
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = learned._pinball(learned._quantiles_from_windows(
        live, torch.from_numpy(xb), 24, 24, "torch"), torch.from_numpy(yb))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    for g, g_r in zip(grads, jax.tree.leaves(grads_r)):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), atol=1e-5)
    new, state, loss2 = learned._train_step(
        opt, params, opt.init(params), torch.from_numpy(xb),
        torch.from_numpy(yb), 24, 24, "torch")
    assert state.step == 1
    assert float(loss2) == pytest.approx(float(loss_r), rel=LOSS_RTOL)
    for a, b in zip(tree_leaves(new), jax.tree.leaves(new_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("scan_impl", ["torch", "kernel"])
def test_three_step_fit_matches_reference(tele, jax_init, scan_impl):
    """The reference's ``test_learned_forecaster_trains_through_pallas``
    fit (3 steps on 96 hours) through the port: ``last_loss`` at rel 1e-5
    and ``predict(6)``."""
    ref = ref_forecast.make_forecaster("learned", train_steps=3, seed=0)
    ref.fit(tele.ci[:96])
    port = _port_learned(train_steps=3, seed=0, scan_impl=scan_impl)
    port.fit(tele.ci[:96])
    assert port.train_count == 1 and port.scan_impl == scan_impl
    assert port.last_loss == pytest.approx(ref.last_loss, rel=LOSS_RTOL)
    fr, fp = ref.predict(6), port.predict(6)
    for k in ("mean", "lo", "hi"):
        np.testing.assert_allclose(getattr(fp, k), getattr(fr, k),
                                   rtol=FC_RTOL, atol=1e-8, err_msg=k)


def test_checkpoints_cross_both_ways(tele, jax_init, tmp_path):
    """A checkpoint the reference saved loads in the port (and the port's
    in the reference): same ``state.npz`` keys, same predictions."""
    ref = ref_forecast.make_forecaster("learned", train_steps=3, seed=0)
    ref.fit(tele.ci[:96])
    ref.save(str(tmp_path / "ref"))
    port = learned.LearnedForecaster.load(str(tmp_path / "ref"),
                                          device="cpu")
    assert port.scan_impl == "torch"          # assoc -> the CPU default
    port.update(tele.ci[:96])
    np.testing.assert_allclose(port.predict(6).mean, ref.predict(6).mean,
                               rtol=FC_RTOL)

    trained = _port_learned(train_steps=3, seed=0)
    trained.fit(tele.ci[:96])
    trained.save(str(tmp_path / "port"), step=2)
    keys = sorted(np.load(tmp_path / "port" / "step-2" / "state.npz"))
    assert keys == sorted(np.load(tmp_path / "ref" / "step-0" / "state.npz"))
    assert "params/block/in_x" in keys and "mu" in keys
    back = ref_learned.LearnedForecaster.load(str(tmp_path / "port"))
    back.update(tele.ci[:96])
    np.testing.assert_allclose(back.predict(6).mean,
                               trained.predict(6).mean, rtol=FC_RTOL)


def test_scan_selection_by_device(tmp_path, tele):
    """``scan_impl=None`` resolves by device; ``torch`` on a CUDA device
    raises; a reference manifest's ``pallas`` maps to ``kernel``."""
    assert _port_learned().scan_impl == "torch"
    assert _port_learned(scan_impl="kernel").scan_impl == "kernel"
    with pytest.raises(ValueError, match="CUDA device takes 'kernel'"):
        forecast.make_forecaster("learned", device="cuda", scan_impl="torch")
    with pytest.raises(ValueError, match="scan_impl"):
        _port_learned(scan_impl="assoc")
    ref = ref_forecast.make_forecaster("learned", train_steps=1,
                                       scan_impl="pallas")
    ref.fit(tele.ci[:96])
    ref.save(str(tmp_path))
    manifest = json.load(open(os.path.join(tmp_path, "step-0",
                                           "manifest.json")))
    assert manifest["config"]["scan_impl"] == "pallas"
    assert learned.LearnedForecaster.load(
        str(tmp_path), device="cpu").scan_impl == "kernel"


# ---------------------------------------------------------------------------
# Optimizer, registry, backtest
# ---------------------------------------------------------------------------

def test_adamw_matches_reference():
    """Three updates of a two-leaf tree: warmup at the incremented step,
    beta2 0.95, clipping before the moments, decay on every leaf."""
    rng = np.random.default_rng(0)
    tree = dict(w=rng.standard_normal((4, 3)).astype(np.float32),
                b=dict(v=rng.standard_normal(3).astype(np.float32)))
    sched_r = ref_cosine(1e-2, 2, 10)
    sched = cosine_schedule(1e-2, 2, 10)
    for s in range(12):
        assert sched(s) == pytest.approx(float(sched_r(jnp.int32(s))),
                                         rel=1e-7)
    opt_r = ref_adamw(lr=sched_r, weight_decay=0.1)
    opt = adamw(lr=sched, weight_decay=0.1)
    p_r = jax.tree.map(jnp.asarray, tree)
    p = tree_map(torch.from_numpy, tree)
    s_r, s = opt_r.init(p_r), opt.init(p)
    for k in range(3):
        g = tree_map(lambda x: (rng.standard_normal(x.shape) * 3).astype(
            np.float32), tree)
        p_r, s_r, gn_r = opt_r.update(jax.tree.map(jnp.asarray, g), s_r, p_r)
        p, s, gn = opt.update(tree_map(torch.from_numpy, g), s, p)
        assert float(gn) == pytest.approx(float(gn_r), rel=1e-6)
        for a, b in zip(tree_leaves(p), jax.tree.leaves(p_r)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_registry_matches_reference():
    assert forecast.list_forecasters() == ref_forecast.list_forecasters()
    with pytest.raises(KeyError, match="did you mean 'holtwinters'"):
        forecast.make_forecaster("holtwinter")
    assert forecast.base.model_class("learned").on_device
    assert forecast.base.model_class("holtwinters").on_device
    assert not forecast.base.model_class("seasonal-naive").on_device


@pytest.mark.parametrize("name", ["persistence", "seasonal-naive", "oracle",
                                  "holtwinters"])
def test_backtest_matches_reference(tele, name):
    kw = dict(horizon=6, warmup=48, stride=6)
    r = ref_forecast.backtest_telemetry(tele, "ci", name, **kw)
    port_tele = convert.telemetry_from_reference(tele)
    dev = dict(device="cpu") if name == "holtwinters" else {}
    p = forecast.backtest_telemetry(port_tele, "ci", name, **kw, **dev)
    assert p["n_origins"] == r["n_origins"]
    for k in ("mape", "pinball", "coverage"):
        assert p[k] == pytest.approx(r[k], rel=FC_RTOL), k
    assert forecast.mape(np.array([1.0, 2.0]), np.array([1.5, 2.0])) == \
        ref_forecast.mape(np.array([1.0, 2.0]), np.array([1.5, 2.0]))
    assert forecast.pinball_loss(np.ones(3), np.zeros(3), 0.9) == \
        ref_forecast.pinball_loss(np.ones(3), np.zeros(3), 0.9)
