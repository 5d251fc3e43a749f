"""The port's CUDA kernels against their plain versions on the card.

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed: ``python -m pytest -m cuda tests/test_torch_cuda.py``
on a machine with a Hopper card. Without a card every test skips."""
import numpy as np
import pytest
import torch

from repro_torch.core import round as port_round
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan import rglru_scan as scan_binding
from repro_torch.kernels.rglru_scan.ref import (rglru_layer_ref,
                                                rglru_scan_chunked_ref,
                                                rglru_scan_ref)
from repro_torch.kernels.sinkhorn import ops, sinkhorn
from repro_torch.kernels.sinkhorn.ref import sinkhorn_iteration_ref

pytestmark = pytest.mark.cuda

# Kernel vs plain version, both float32 on the card (the scan kernel's
# step is one fmaf where the plain version rounds twice).
ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("M,N", [(4, 6), (4096, 6), (16384, 41)])
def test_kernel_matches_plain_on_card(card, M, N):
    rng = np.random.default_rng(M + N)
    C = torch.from_numpy(rng.random((M, N)).astype(np.float32)).to(card)
    g = torch.from_numpy((rng.standard_normal(N) * 0.1).astype(
        np.float32)).to(card)
    log_a = torch.full((M,), -float(np.log(M)), device=card)
    b = rng.random(N) + 0.5
    log_b = torch.from_numpy(np.log(b / b.sum()).astype(np.float32)).to(card)
    for eps in (0.5, 0.005):
        before = sinkhorn.LAUNCHES
        f_k, g_k = ops.sinkhorn_iteration(C, None, g, log_a, log_b, eps)
        torch.cuda.synchronize()
        assert sinkhorn.LAUNCHES == before + sinkhorn.LAUNCHES_PER_ITERATION
        f_r, g_r = sinkhorn_iteration_ref(C, None, g, log_a, log_b, eps)
        assert (f_k - f_r).abs().max().item() <= ATOL
        assert (g_k - g_r).abs().max().item() <= ATOL


@pytest.mark.parametrize("N", [6, 41])
@pytest.mark.parametrize("M", [4, 512, 4096, 16384])
def test_anneal_is_bitwise_the_iteration_loop(card, M, N):
    """The one-launch annealed solve against 360 calls of the iteration
    kernel over the same float32 eps table: f and g bit for bit (same row
    partition, same reduction trees); and within ATOL of the plain loop."""
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_ref
    rng = np.random.default_rng(M * 7 + N)
    C = torch.from_numpy(rng.random((M, N)).astype(np.float32)).to(card)
    log_a = torch.full((M,), -float(np.log(M)), device=card)
    b = rng.random(N) + 0.5
    log_b = torch.from_numpy(np.log(b / b.sum()).astype(np.float32)).to(card)
    table = ops.eps_table(0.5, 0.005, 6)
    before = (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES)
    f_a, g_a = ops.sinkhorn_solve(C, log_a, log_b, table, 60)
    torch.cuda.synchronize()
    assert (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES) == (before[0],
                                                             before[1] + 1)
    f = torch.zeros(M, device=card)
    g = torch.zeros(N, device=card)
    for eps in table:
        for _ in range(60):
            f, g = sinkhorn.sinkhorn_iteration_cuda(C, g, log_a, log_b, eps)
    assert torch.equal(f_a, f) and torch.equal(g_a, g)
    f_r, g_r = sinkhorn_solve_ref(C, log_a, log_b, table, 60)
    assert (f_a - f_r).abs().max().item() <= ATOL
    assert (g_a - g_r).abs().max().item() <= ATOL


def test_kernel_rejects_bad_inputs(card):
    C = torch.rand(128, 6, device=card)
    g, log_a, log_b = (torch.zeros(6, device=card),
                       torch.zeros(128, device=card),
                       torch.zeros(6, device=card))
    with pytest.raises(TypeError):
        ops.sinkhorn_iteration(C.double(), None, g.double(), log_a.double(),
                               log_b.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sinkhorn_iteration(C.t().contiguous().t(), None, g, log_a, log_b,
                               0.5)
    with pytest.raises(ValueError, match="shape"):
        ops.sinkhorn_iteration(C, None, g, log_a[:64], log_b, 0.5)


def test_fused_round_on_card_goes_through_kernel(card):
    rng = np.random.default_rng(3)
    M, N = 60, 6
    cost = rng.random((M, N)) * 10
    allowed = rng.random((M, N)) > 0.2
    allowed[np.arange(M), rng.integers(0, N, M)] = True
    cap = np.full(N, (M + N) // N + 1)
    before = (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES)
    res = port_round.fused_solve(cost, allowed, cap)
    assert res.feasible and res.backend == "fused"
    # One launch of the annealed solve, none of the per-iteration kernel.
    assert (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES) == (before[0],
                                                             before[1] + 1)


def test_fused_round_on_card_takes_only_the_kernel(card):
    rng = np.random.default_rng(4)
    cost = rng.random((10, 5)) * 10
    allowed = np.ones((10, 5), bool)
    cap = np.full(5, 4)
    with pytest.raises(ValueError, match="CUDA device takes 'kernel'"):
        port_round.fused_solve(cost, allowed, cap, sinkhorn_impl="torch")


@pytest.mark.parametrize("B,S,W", [(64, 48, 16), (75, 48, 16), (16, 48, 16),
                                   (5, 29, 16), (2, 7, 15), (2, 128, 128),
                                   (4, 2048, 2560)])
def test_scan_kernels_match_plain_on_card(card, B, S, W):
    gen = torch.Generator().manual_seed(B + S + W)
    a = (torch.rand((B, S, W), generator=gen) * 0.95).to(card)
    bx = torch.randn((B, S, W), generator=gen).to(card)
    w = torch.randn((B, S, W), generator=gen).to(card)
    before = dict(scan_binding.LAUNCHES)
    grads = []
    for scan in (scan_ops.rglru_scan, rglru_scan_ref):
        at = a.clone().requires_grad_(True)
        bt = bx.clone().requires_grad_(True)
        y = scan(at, bt)
        (w * y).sum().backward()
        grads.append((y.detach(), at.grad, bt.grad))
    torch.cuda.synchronize()
    assert scan_binding.LAUNCHES == dict(before, fwd=before["fwd"] + 1,
                                         bwd=before["bwd"] + 1)
    for k, r in zip(*grads):
        assert (k - r).abs().max().item() <= ATOL
    # The kernels take the chunks of the plain chunk-order twin.
    y_twin = rglru_scan_chunked_ref(a, bx, scan_binding.chunk_for(S))
    assert (grads[0][0] - y_twin).abs().max().item() <= ATOL


def test_scan_kernel_rejects_bad_inputs(card):
    a = torch.rand(2, 7, 15, device=card)
    with pytest.raises(TypeError):
        scan_binding.rglru_scan_fwd_cuda(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        scan_binding.rglru_scan_fwd_cuda(a.transpose(1, 2).contiguous()
                                         .transpose(1, 2), a)
    with pytest.raises(ValueError, match="shape"):
        scan_binding.rglru_scan_bwd_cuda(a, a, a[:1])


def _layer_inputs(card, B, S, W, seed, clamp=False):
    gen = torch.Generator().manual_seed(seed)
    pre_r = torch.randn((B, S, W), generator=gen) - (50.0 if clamp else 0.0)
    pre_i, x = (torch.randn((B, S, W), generator=gen) for _ in range(2))
    lam = torch.randn((W,), generator=gen) * 0.5
    w = torch.randn((B, S, W), generator=gen)
    return [t.to(card) for t in (pre_r, pre_i, x, lam)], w.to(card)


@pytest.mark.parametrize("B,S,W,clamp", [
    (64, 48, 16, False), (16, 48, 16, False), (5, 29, 16, False),
    (2, 7, 15, False), (4, 48, 16, True), (4, 2048, 2560, False)])
def test_fused_layer_matches_plain_on_card(card, B, S, W, clamp):
    """The fused layer, one launch each way, against autograd through its
    plain version: y and the four gradients within ATOL; at the clamp
    every gradient through the gates is tiny, so each is held to 1e-3 of
    its largest element (as chip_smoke.py's CLAMP_RTOL)."""
    inputs, w = _layer_inputs(card, B, S, W, B + S + W, clamp)
    before = dict(scan_binding.LAUNCHES)
    out = []
    for layer in (scan_ops.rglru_layer, rglru_layer_ref):
        live = [t.clone().requires_grad_(True) for t in inputs]
        y = layer(*live)
        out.append((y.detach(), *torch.autograd.grad((w * y).sum(), live)))
    torch.cuda.synchronize()
    assert scan_binding.LAUNCHES == dict(
        before, layer_fwd=before["layer_fwd"] + 1,
        layer_bwd=before["layer_bwd"] + 1)
    (y_k, *g_k), (y_r, *g_r) = out
    assert (y_k - y_r).abs().max().item() <= ATOL
    for k, r in zip(g_k, g_r):
        if clamp:
            assert ((k - r).abs().max() / r.abs().max()).item() <= 1e-3
        else:
            assert (k - r).abs().max().item() <= ATOL


def test_fused_layer_rejects_bad_inputs(card):
    t = torch.rand(2, 7, 15, device=card)
    lam = torch.rand(15, device=card)
    with pytest.raises(TypeError):
        scan_binding.rglru_layer_fwd_cuda(t.double(), t, t, lam)
    with pytest.raises(ValueError, match="contiguous"):
        scan_binding.rglru_layer_fwd_cuda(
            t, t.transpose(1, 2).contiguous().transpose(1, 2), t, lam)
    with pytest.raises(ValueError, match="shape"):
        scan_binding.rglru_layer_fwd_cuda(t, t, t, lam[:5])
    with pytest.raises(ValueError, match="shape"):
        scan_binding.rglru_layer_bwd_cuda(t, t, t, lam, t, t[:1])
    with pytest.raises(ValueError, match="CUDA"):
        scan_binding.rglru_layer_bwd_cuda(t, t, t, lam.cpu(), t, t)


def test_forward_only_kernels_refuse_grad_on_card(card):
    """The flash and SSD kernels' raw launchers have no backward: with
    grad enabled and an input that requires grad they raise and launch
    nothing, where they once returned an output without a grad_fn; under
    no_grad they run (the public wrappers carry the gradient: see
    ``test_*_wrapper_carries_gradient_on_card``)."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    q, k, v = (torch.randn((n, 128, 64), device=card) for n in (2, 1, 1))
    x = torch.randn((1, 128, 2, 16), device=card)
    dt = torch.rand((1, 128, 2), device=card) * 0.5 + 0.1
    A = -torch.rand(2, device=card) - 0.2
    Bm, Cm = (torch.randn((1, 128, 1, 8), device=card) for _ in range(2))
    calls = (lambda: fb.flash_attention_bh_cuda(q, k, v, group=2),
             lambda: sb.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=64))
    q.requires_grad_(True)
    Bm.requires_grad_(True)
    before = (fb.LAUNCHES, sb.LAUNCHES)
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
    assert (fb.LAUNCHES, sb.LAUNCHES) == before
    with torch.no_grad():
        for call in calls:
            call()
    torch.cuda.synchronize()
    assert (fb.LAUNCHES, sb.LAUNCHES) == (before[0] + 1, before[1] + 1)


# (dtype, D_qk, D_v, causal, Sq, Skv): every wgmma instantiation, causal
# and (D 64) non-causal with Sq != Skv, and the scalar float32 kernel on the
# heads-first path.
GRAD_FLASH = [
    (torch.bfloat16, 64, 64, True, 160, 160),
    (torch.bfloat16, 64, 64, False, 96, 160),
    (torch.bfloat16, 128, 128, True, 160, 160),
    (torch.bfloat16, 256, 256, True, 160, 160),
    (torch.bfloat16, 96, 64, True, 160, 160),
    (torch.bfloat16, 192, 128, True, 160, 160),
    (torch.float32, 64, 64, True, 160, 160),
]


@pytest.mark.parametrize("dtype,D,Dv,causal,Sq,Skv", GRAD_FLASH)
def test_flash_wrapper_carries_gradient_on_card(card, dtype, D, Dv, causal,
                                                Sq, Skv):
    """``ops.flash_attention`` under grad: the forward is one kernel launch,
    its output within the kernel-vs-plain limits; the backward launches
    nothing, and its gradients (the blocked plain version's, kv blocks of
    64) equal autograd through the plain version within the same limits.
    The raw launchers still refuse the same inputs."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator().manual_seed(D + Dv + Sq)
    B, Kh, G = 2, 2, 2
    inputs = [torch.randn(s, generator=gen).to(card, dtype) for s in (
        (B, Sq, Kh, G, D), (B, Skv, Kh, D), (B, Skv, Kh, Dv))]
    w = torch.randn((B, Sq, Kh, G, Dv), generator=gen).to(card, dtype)

    def run(fn):
        live = [t.clone().requires_grad_(True) for t in inputs]
        out = fn(*live)
        return [out.detach(), *torch.autograd.grad((out * w).sum(), live)]
    kw = dict(causal=causal)
    before = fb.LAUNCHES
    got = run(lambda q, k, v: fops.flash_attention(q, k, v, block_kv=64,
                                                   **kw))
    torch.cuda.synchronize()
    assert fb.LAUNCHES == before + 1
    want = run(lambda q, k, v: flash_attention_ref(q, k, v, **kw))
    f32 = dtype == torch.float32
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=2e-5 if f32 else 2e-2,
                                   rtol=1e-5 if f32 else BF16_RTOL)
    q = inputs[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fb.flash_attention_cuda(q.flatten(2, 3), *inputs[1:], **kw)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", [
    (2, 192, 4, 64, 2, 64, 64, torch.bfloat16),
    (2, 100, 4, 16, 2, 8, 32, torch.float32),
])
def test_ssd_wrapper_carries_gradient_on_card(card, b, S, H, P, G, N, chunk,
                                              dtype):
    """``ops.ssd_scan`` under grad on the wgmma (bf16 P 64) and scalar
    (float32) kernels: one call forward, none backward; y, the final state
    and the five gradients equal autograd through the plain chunked
    version within the file's SSD limits. The raw launcher still refuses
    the same inputs."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    gen = torch.Generator().manual_seed(S + P)
    x = torch.randn((b, S, H, P), generator=gen).to(card, dtype)
    dt = (torch.rand((b, S, H), generator=gen) * 0.5 + 0.1).to(card)
    A = (-torch.rand(H, generator=gen) - 0.2).to(card)
    Bm, Cm = (torch.randn((b, S, G, N), generator=gen).to(card, dtype)
              for _ in range(2))
    wy = torch.randn((b, S, H, P), generator=gen).to(card)
    ws = torch.randn((b, H, P, N), generator=gen).to(card)

    def run(fn):
        live = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y, st = fn(*live)
        loss = (y.float() * wy).sum() + (st.float() * ws).sum()
        return [y.detach(), st.detach(), *torch.autograd.grad(loss, live)]
    kind = sb.variant(dtype, P, N, chunk)
    before = dict(sb.LAUNCHES_BY_VARIANT)
    got = run(lambda *t: sops.ssd_scan(*t, chunk=chunk))
    torch.cuda.synchronize()
    assert sb.LAUNCHES_BY_VARIANT == {**before, kind: before[kind] + 1}
    want = run(lambda *t: ssd_ref(*t, chunk=chunk))
    rtol = 0 if dtype == torch.float32 else BF16_RTOL
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b_.float(), atol=2e-3,
                                   rtol=rtol)
    with pytest.raises(RuntimeError, match="forward-only"):
        sb.ssd_scan_cuda(x, dt.clone().requires_grad_(True), A, Bm, Cm,
                         chunk=chunk)


@pytest.mark.parametrize("arch,over", [
    ("qwen2_1_5b", dict(head_dim=64)),
    ("mamba2_2_7b", dict(ssm_head_dim=64, ssm_state=64, ssd_chunk=64)),
    ("recurrentgemma_2b", dict(n_layers=3, head_dim=64)),
])
def test_bf16_train_step_runs_through_kernels_on_card(card, arch, over):
    """A 2-layer (griffin: one group) bf16 ``make_train_step`` with
    grad_accum=2 at S 128 on the card, remat "full": the wgmma flash, the
    wgmma SSD and the fused RG-LRU kernels launch; the loss, grad_norm,
    every first moment (the clipped gradients) and every updated
    parameter are finite, and the moments are not all zero."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    from repro_torch.models import rglru, ssm
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train_loop import make_train_step
    cfg = get_config(arch, reduced=True).replace(remat="full", **over)
    if cfg.ssm:
        cfg = cfg.replace(d_inner=2 * cfg.ssm_head_dim)
    model = Model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    # Live recurrences: the init's zero convs would carry zeros and leave
    # the SSM and RG-LRU scalars without a gradient.
    rng = np.random.default_rng(0)
    if cfg.ssm:
        mixers = [(lp["mixer"], ssm.draw_live_mixer)
                  for lp in params["layers"]]
    else:
        mixers = [(g[n]["mixer"], rglru.draw_live_block)
                  for g in params.get("groups", []) for n in ("rec1", "rec2")]
    for mixer, draw in mixers:
        for k, v in draw(rng, cfg).items():
            mixer[k] = torch.from_numpy(v).to(card, mixer[k].dtype)
    opt = adamw()
    step = make_train_step(model, opt, grad_accum=2)
    batch = SyntheticTokens(cfg.vocab, 128, 4).batch(0)
    before = (dict(fb.LAUNCHES_BY_VARIANT), dict(sb.LAUNCHES_BY_VARIANT),
              dict(scan_binding.LAUNCHES))
    params, state, met = step(params, opt.init(params), batch)
    torch.cuda.synchronize()
    flash = fb.LAUNCHES_BY_VARIANT["wgmma"] - before[0]["wgmma"]
    ssd = sb.LAUNCHES_BY_VARIANT["wgmma"] - before[1]["wgmma"]
    rglru = {k: scan_binding.LAUNCHES[k] - before[2][k]
             for k in ("layer_fwd", "layer_bwd")}
    # Forward and remat recompute, for each of two microbatches.
    if cfg.ssm:
        assert (flash, ssd) == (0, 4 * cfg.n_layers)
    elif cfg.family == "griffin":
        assert (flash, ssd) == (4, 0)
        assert rglru == dict(layer_fwd=8, layer_bwd=4)
    else:
        assert (flash, ssd) == (4 * cfg.n_layers, 0)
    assert fb.LAUNCHES_BY_VARIANT["scalar"] == before[0]["scalar"]
    assert np.isfinite(float(met["loss"])) and np.isfinite(
        float(met["grad_norm"]))
    for t in tree_leaves(state.mu) + tree_leaves(params):
        assert torch.isfinite(t.float()).all()
    assert all(float(t.abs().max()) > 0 for t in tree_leaves(state.mu)
               if t.numel() > 1)


def test_learned_forecaster_trains_through_kernels_on_card(card):
    from repro_torch import forecast
    from repro_torch.core import telemetry
    y = telemetry.generate(days=6, seed=0).ci[:96]
    with pytest.raises(ValueError, match="CUDA device takes 'kernel'"):
        forecast.make_forecaster("learned", scan_impl="torch")
    f = forecast.make_forecaster("learned", train_steps=3, seed=0)
    assert f.device.type == "cuda" and f.scan_impl == "kernel"
    before = dict(scan_binding.LAUNCHES)
    f.fit(y)
    # 3 steps + 2 validation passes (the init and the last step) + the
    # conditioning pass through the fused forward; one fused backward per
    # step; the scan-only kernels not at all.
    assert scan_binding.LAUNCHES == dict(
        before, layer_fwd=before["layer_fwd"] + 6,
        layer_bwd=before["layer_bwd"] + 3)
    host = forecast.make_forecaster("learned", train_steps=3, seed=0,
                                    device="cpu").fit(y)
    np.testing.assert_allclose(f.predict(6).mean, host.predict(6).mean,
                               rtol=1e-4)


def test_fused_temporal_round_on_card_goes_through_kernel(card):
    from repro_torch.core import footprint, problem, telemetry
    tele = telemetry.generate(days=2, seed=0)
    M, S, R = 30, 8, 5
    rng = np.random.default_rng(0)
    jobs = [problem.Job(job_id=i, home_region=i % R, submit_time_s=0.0,
                        exec_time_s=600.0, energy_kwh=0.05, tolerance=4.0)
            for i in range(M)]
    server = footprint.m5_metal()
    snap = tele.at(0.0)
    inst = problem.build(jobs, tele, 0.0, np.full(R, 8), server, snap=snap)
    sig = [rng.random((M, S, R)) * k + 0.5 for k in (300, 2, 1)]
    args = (inst, 0.0, *sig, snap["pue"], snap["wsf"], np.arange(S) * 1800.0,
            server, 0.5, 0.5)
    before = (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES)
    _, _, _, res = port_round.fused_temporal_round(*args)
    assert res.feasible
    assert (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES) == (before[0],
                                                             before[1] + 1)
    _, _, _, host = port_round.fused_temporal_round(*args, device="cpu")
    assert host.status == res.status


# --- LM serving path: flash attention and the SSD scan -----------------------

# bf16 outputs of kernel and plain version round independently: one bf16
# step (at most 2^-7 of the value: bf16 keeps 8 significant bits) on top
# of the reference kernel tests' atol.
BF16_RTOL = 2.0 ** -7


@pytest.mark.parametrize("BH,S,D,causal,window,dtype,group", [
    (4, 256, 64, True, 0, torch.float32, 1),
    (2, 512, 128, True, 0, torch.float32, 1),
    (2, 256, 64, False, 0, torch.float32, 1),
    (2, 512, 64, True, 100, torch.float32, 1),
    (2, 256, 128, True, 0, torch.bfloat16, 1),
    (1, 128, 256, True, 64, torch.float32, 1),
    (8, 1000, 16, True, 0, torch.float32, 4),
])
def test_flash_kernel_matches_plain_on_card(card, BH, S, D, causal, window,
                                            dtype, group):
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    gen = torch.Generator().manual_seed(BH + S + D)
    q = torch.randn((BH, S, D), generator=gen).to(card, dtype)
    k, v = (torch.randn((BH // group, S, D), generator=gen).to(card, dtype)
            for _ in range(2))
    before = fb.LAUNCHES
    out = fops.flash_attention_bh(q, k, v, causal=causal, window=window,
                                  group=group)
    torch.cuda.synchronize()
    assert fb.LAUNCHES == before + 1
    ref = flash_attention_bh_ref(q, k, v, causal=causal, window=window,
                                 group=group)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=0 if dtype == torch.float32
                               else BF16_RTOL)


@pytest.mark.parametrize("group", [1, 2, 6])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)])
@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_flash_kernel_matches_plain_on_card(card, D, causal, window,
                                                  group):
    """The tensor-core kernel (bf16, D 64 and 128) against the plain version
    at Sq = Skv = 1000 (ragged for its 128-row tiles): causal, sliding and
    full masks, groups 1, 2 and 6; bf16 limit 2e-2 plus one bf16 step."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    gen = torch.Generator().manual_seed(D + group + window)
    BH, S = 2 * group, 1000
    q = torch.randn((BH, S, D), generator=gen).to(card, torch.bfloat16)
    k, v = (torch.randn((BH // group, S, D), generator=gen).to(
        card, torch.bfloat16) for _ in range(2))
    before = dict(fb.LAUNCHES_BY_VARIANT)
    out = fops.flash_attention_bh(q, k, v, causal=causal, window=window,
                                  group=group)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT == dict(wgmma=before["wgmma"] + 1,
                                          scalar=before["scalar"])
    ref = flash_attention_bh_ref(q, k, v, causal=causal, window=window,
                                 group=group)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=BF16_RTOL)


# Query offsets of a sequence segment against its prefix's keys: (D, Dv,
# Sq, q_offset, window, dtype); offsets on and off the 128-row and -key
# tiles, windows, MLA's dims, bf16 on the wgmma kernel and float32 on the
# scalar one; and one whose K and V outgrow L2, so that the wgmma kernel
# deals pairs of q tiles.
OFFSET_FLASH = [(64, 64, 300, 333, 0, torch.bfloat16),
                (128, 128, 256, 128, 0, torch.bfloat16),
                (128, 128, 200, 1000, 300, torch.bfloat16),
                (256, 256, 150, 77, 100, torch.bfloat16),
                (96, 64, 130, 390, 0, torch.bfloat16),
                (192, 128, 64, 1, 0, torch.bfloat16),
                (128, 128, 2048, 14336, 0, torch.bfloat16),
                (64, 64, 100, 333, 0, torch.float32),
                (128, 128, 64, 70, 50, torch.float32),
                (256, 256, 70, 129, 0, torch.float32)]


@pytest.mark.parametrize("D,Dv,Sq,off,window,dtype", OFFSET_FLASH)
def test_flash_kernels_at_a_query_offset_on_card(card, D, Dv, Sq, off,
                                                 window, dtype):
    """The model-layout wrapper with ``q_offset``: one launch of the kernel
    ``kernel_call`` names, its Sq queries at offset ``off`` against the
    off + Sq keys of their prefix, against the plain version at the same
    offset and against rows [off, off + Sq) of the whole prefix's plain
    attention (bf16 limit 2e-2 plus one bf16 step, float32 2e-5); at
    offset 0 the call is bitwise the call without the keyword."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator().manual_seed(D + Sq + off)
    Kh, G, S = 2, 4 if D == Dv else 1, off + Sq
    q = torch.randn((1, S, Kh, G, D), generator=gen).to(card, dtype)
    k = torch.randn((1, S, Kh, D), generator=gen).to(card, dtype)
    v = torch.randn((1, S, Kh, Dv), generator=gen).to(card, dtype)
    scale = 1.0 / np.sqrt(D) if D != Dv else None
    kw = dict(causal=True, window=window, scale=scale)
    before = fb.LAUNCHES
    out = fops.flash_attention(q[:, off:], k, v, q_offset=off, **kw)
    torch.cuda.synchronize()
    assert fb.LAUNCHES == before + 1
    tol = (dict(atol=2e-2, rtol=BF16_RTOL) if dtype == torch.bfloat16
           else dict(atol=2e-5, rtol=0))
    ref = flash_attention_ref(q[:, off:], k, v, q_offset=off, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    whole = flash_attention_ref(q, k, v, **kw)[:, off:]
    torch.testing.assert_close(out.float(), whole.float(), **tol)
    head = q[:, :Sq].contiguous()
    assert torch.equal(
        fops.flash_attention(head, k[:, :Sq], v[:, :Sq], q_offset=0, **kw),
        fops.flash_attention(head, k[:, :Sq], v[:, :Sq], **kw))


@pytest.mark.parametrize("group", [1, 2, 10])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)])
def test_wgmma_flash_kernel_at_d256_matches_plain_on_card(card, causal,
                                                          window, group):
    """The tensor-core kernel's D 256 instantiation (64-key tiles, two
    stages) against the plain version at Sq = Skv = 1000 (ragged for both
    its 128-row q tiles and its 64-key kv tiles): causal, sliding and full
    masks, groups 1, 2 and 10 (recurrentgemma's MQA); bf16 limit 2e-2 plus
    one bf16 step."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    gen = torch.Generator().manual_seed(256 + group + window)
    BH, S, D = 2 * group, 1000, 256
    q = torch.randn((BH, S, D), generator=gen).to(card, torch.bfloat16)
    k, v = (torch.randn((BH // group, S, D), generator=gen).to(
        card, torch.bfloat16) for _ in range(2))
    before = dict(fb.LAUNCHES_BY_VARIANT)
    out = fops.flash_attention_bh(q, k, v, causal=causal, window=window,
                                  group=group)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT == dict(wgmma=before["wgmma"] + 1,
                                          scalar=before["scalar"])
    ref = flash_attention_bh_ref(q, k, v, causal=causal, window=window,
                                 group=group)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=BF16_RTOL)


# gemma3-4b's prefill (B 4: 32 query heads over 16 kv heads; local window
# 1024 and the global layers' BIG_WINDOW) and recurrentgemma-2b's (40 query
# heads over 4 kv heads: MQA, window 2048).
GEMMA_FLASH = [(32, 2, 1024), (32, 2, 1 << 30), (40, 10, 2048)]


def _gemma_inputs(card, BH, group):
    gen = torch.Generator().manual_seed(BH + group)
    S, D = 2048, 256
    q = torch.randn((BH, S, D), generator=gen).to(card, torch.bfloat16)
    k, v = (torch.randn((BH // group, S, D), generator=gen).to(
        card, torch.bfloat16) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("BH,group,window", GEMMA_FLASH)
def test_wgmma_flash_kernel_at_gemma_shapes_on_card(card, BH, group,
                                                    window):
    """bf16 at D 256, S 2048, the gemma models' per-call shapes, takes the
    wgmma kernel (one launch, no scalar one) and agrees with the plain
    version: bf16 limit 2e-2 plus one bf16 step."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    q, k, v = _gemma_inputs(card, BH, group)
    assert fb.variant(torch.bfloat16, 256) == "wgmma"
    before = dict(fb.LAUNCHES_BY_VARIANT)
    out = fops.flash_attention_bh(q, k, v, causal=True, window=window,
                                  group=group)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT == dict(wgmma=before["wgmma"] + 1,
                                          scalar=before["scalar"])
    ref = flash_attention_bh_ref(q, k, v, causal=True, window=window,
                                 group=group)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=BF16_RTOL)


@pytest.mark.parametrize("BH,group,window", GEMMA_FLASH)
def test_scalar_flash_kernel_at_gemma_shapes_on_card(card, BH, group,
                                                     window):
    """The scalar kernel, launched directly (no model path reaches it in
    bf16 at D 256 now), at the gemma models' per-call shapes: the
    yardstick the wgmma kernel is timed beside stays held to the plain
    version, bf16 limit 2e-2 plus one bf16 step."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    q, k, v = _gemma_inputs(card, BH, group)
    before = dict(fb.LAUNCHES_BY_VARIANT)
    out = fb._launch("scalar", q, k, v, causal=True, window=window,
                     scale=None, group=group)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT == dict(wgmma=before["wgmma"],
                                          scalar=before["scalar"] + 1)
    ref = flash_attention_bh_ref(q, k, v, causal=True, window=window,
                                 group=group)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=BF16_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_griffin_block_prefill_goes_through_kernel_on_card(card, dtype):
    """The RG-LRU block's prefill on the card (one ``rglru_layer_fwd``
    launch) against the same block with the plain layer on the card; the
    cache's state is the plain recurrence's last step."""
    from repro_torch.configs import get_config
    from repro_torch.models import rglru
    from repro_torch.models.common import split_tree
    cfg = get_config("recurrentgemma_2b", reduced=True).replace(
        lru_width=256)
    gen = torch.Generator().manual_seed(5)
    p, _ = split_tree(rglru.block_init(gen, 128, lru_width=256,
                                       dtype=dtype))
    p.update({k: torch.from_numpy(v).to(p[k].dtype) for k, v in
              rglru.draw_live_block(np.random.default_rng(5), cfg).items()})
    p = {k: v.to(card) for k, v in p.items()}
    x = torch.randn((2, 300, 128), generator=gen).to(card, dtype)
    before = dict(scan_binding.LAUNCHES)
    with torch.inference_mode():
        out, cache = rglru.block_apply(x, p, mode="prefill")
        torch.cuda.synchronize()
        assert scan_binding.LAUNCHES == dict(
            before, layer_fwd=before["layer_fwd"] + 1)
        plain, _ = rglru.block_apply(x, p, mode="train",
                                     layer=rglru_layer_ref)
        h = rglru_layer_ref(*rglru._layer_inputs(
            rglru._causal_conv(x @ p["in_x"], p["conv_w"], p["conv_b"])[0],
            p))
    atol = ATOL if dtype == torch.float32 else 2e-2
    rtol = 0 if dtype == torch.float32 else BF16_RTOL
    torch.testing.assert_close(out.float(), plain.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(cache["state"].float(),
                               h[:, -1].to(dtype).float(), atol=atol,
                               rtol=rtol)
    assert float(h.abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["gemma3_4b", "recurrentgemma_2b"])
def test_gemma_server_on_card_goes_through_kernels(card, arch,
                                                   monkeypatch):
    """Reduced config, float32, live RG-LRU draws, weights drawn on the CPU
    and copied: the card's prefill launches the flash kernel once per
    attention layer and ``rglru_layer_fwd`` once per recurrent layer, calls
    no plain version, and ``Server.generate`` gives the CPU's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import attention, rglru
    from repro_torch.models.model import Model, to_device
    from repro_torch.runtime.serve_loop import Server
    cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                 param_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    recs = [g[n] for g in params.get("groups", []) for n in ("rec1", "rec2")]
    for lp in recs + params.get("tail", []):
        lp["mixer"].update({k: torch.from_numpy(v) for k, v in
                            rglru.draw_live_block(rng, cfg).items()})
    n_rec = len(recs) + len(params.get("tail", []))
    n_attn = cfg.n_layers - n_rec
    plain = []
    for mod, name in ((scan_ops, "rglru_layer_ref"),
                      (scan_ops, "rglru_scan_ref"),
                      (attention, "blocked_attention"),
                      (fops, "flash_attention_bh_ref")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (
            plain.append(_n), _fn(*a, **kw))[1])
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
    card_params = to_device(params, card)
    before = (fb.LAUNCHES, scan_binding.LAUNCHES["layer_fwd"])
    with torch.inference_mode():
        model.prefill(card_params, dict(tokens=torch.from_numpy(toks).to(
            card)))
    torch.cuda.synchronize()
    assert (fb.LAUNCHES - before[0],
            scan_binding.LAUNCHES["layer_fwd"] - before[1]) == (n_attn,
                                                                 n_rec)
    assert plain == []
    out = Server(model, card_params).generate(dict(tokens=toks), max_new=4)
    host = Server(model, params, device="cpu").generate(dict(tokens=toks),
                                                        max_new=4)
    np.testing.assert_array_equal(out, host)


def test_flash_kernel_rejects_bad_inputs(card):
    from repro_torch.kernels.flash_attention import flash_attention as fb
    q = torch.zeros((4, 64, 64), device=card)
    with pytest.raises(TypeError):
        fb.flash_attention_bh_cuda(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="head dim"):
        fb.flash_attention_bh_cuda(q[..., :48].contiguous(),
                                   q[..., :48].contiguous(),
                                   q[..., :48].contiguous())
    with pytest.raises(ValueError, match="group"):
        fb.flash_attention_bh_cuda(q, q[:3].contiguous(), q[:3].contiguous(),
                                   group=2)
    with pytest.raises(ValueError, match="contiguous"):
        fb.flash_attention_bh_cuda(q.transpose(1, 2), q, q)
    # The wgmma kernel's TMA loads need 16-byte aligned bases, at D 256 too.
    flat = torch.zeros(2 * 32 * 256 + 4, dtype=torch.bfloat16, device=card)
    shifted = flat[4:].view(2, 32, 256)
    q256 = torch.zeros((2, 32, 256), dtype=torch.bfloat16, device=card)
    before = fb.LAUNCHES
    with pytest.raises(ValueError, match="aligned"):
        fb.flash_attention_bh_cuda(q256, shifted, q256)
    assert fb.LAUNCHES == before


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", [
    (2, 64, 4, 16, 2, 8, 16, torch.float32),
    (2, 128, 2, 32, 1, 16, 32, torch.float32),
    (2, 64, 8, 64, 8, 8, 64, torch.float32),
    (2, 100, 4, 16, 2, 8, 16, torch.float32),
    (1, 600, 8, 64, 1, 128, 256, torch.bfloat16),
    # bf16 calls the wgmma kernel does not take (chunks of S = 100 rows;
    # P 32): the scalar kernel in bf16.
    (2, 100, 8, 64, 1, 128, 256, torch.bfloat16),
    (2, 160, 4, 32, 2, 64, 64, torch.bfloat16),
])
def test_ssd_kernel_matches_plain_on_card(card, b, S, H, P, G, N, chunk,
                                          dtype):
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    gen = torch.Generator().manual_seed(S + H + P)
    x = torch.randn((b, S, H, P), generator=gen).to(card, dtype)
    dt = (torch.rand((b, S, H), generator=gen) * 0.5 + 0.1).to(card)
    A = (-torch.rand(H, generator=gen) - 0.2).to(card)
    Bm, Cm = (torch.randn((b, S, G, N), generator=gen).to(card, dtype)
              for _ in range(2))
    kind = sb.variant(dtype, P, N, min(chunk, S))
    before, by_variant = sb.LAUNCHES, dict(sb.LAUNCHES_BY_VARIANT)
    y, st = sops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    # One call (of KERNELS_PER_CALL[kind] device launches), of its variant.
    assert sb.LAUNCHES == before + 1
    assert sb.LAUNCHES_BY_VARIANT == {**by_variant,
                                      kind: by_variant[kind] + 1}
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, chunk=min(chunk, S))
    rtol = 0 if dtype == torch.float32 else BF16_RTOL
    torch.testing.assert_close(y.float(), yr.float(), atol=2e-3, rtol=rtol)
    torch.testing.assert_close(st.float(), sr.float(), atol=2e-3, rtol=rtol)


def _ssd_model_like(card, seed, b, S, H, P, G, N):
    """Inputs as the Mamba-2 block hands them to the scan (chip_smoke.py's
    model-like draws, made on the CPU): x, B, C SiLU outputs of unit
    normals in bf16, dt and A at Mamba-2's init ranges."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.numerics import softplus
    gen = torch.Generator().manual_seed(seed)
    cfg = get_config("mamba2_2_7b").replace(
        d_inner=H * P, ssm_head_dim=P, ssm_groups=G, ssm_state=N)
    mix = ssm.draw_live_mixer(np.random.default_rng(seed), cfg)
    x = F.silu(torch.randn((b, S, H, P), generator=gen)).bfloat16()
    dt = softplus(0.5 * torch.randn((b, S, H), generator=gen)
                  + torch.from_numpy(mix["dt_bias"]))
    A = -torch.exp(torch.from_numpy(mix["A_log"]))
    Bm, Cm = (F.silu(torch.randn((b, S, G, N), generator=gen)).bfloat16()
              for _ in range(2))
    return [t.to(card) for t in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,model_like", [
    (1, 600, 8, 64, 1, 128, 256, False),
    (1, 600, 8, 64, 2, 128, 256, False),
    (2, 300, 8, 64, 2, 128, 64, False),
    (2, 300, 8, 64, 1, 128, 128, False),
    (2, 300, 8, 64, 2, 64, 128, False),
    (1, 600, 8, 64, 1, 128, 192, False),
    (2, 192, 8, 64, 2, 64, 256, False),
    (1, 2048, 80, 64, 1, 128, 256, True),
])
def test_wgmma_ssd_kernel_matches_plain_on_card(card, b, S, H, P, G, N,
                                                chunk, model_like):
    """The chunk-parallel tensor-core kernel (bf16, P 64) against the plain
    chunked version: ragged S, G 1 and 2 over 8 heads, chunks of 64, 128,
    192 and 256 (and one longer than S, so of S = 192 rows), N 64 and 128,
    and mamba2-2.7B's shape at B 1 drawn as the model draws; limit 2e-3
    plus one bf16 step, on y and the state."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    if model_like:
        x, dt, A, Bm, Cm = _ssd_model_like(card, 0, b, S, H, P, G, N)
    else:
        gen = torch.Generator().manual_seed(S + H + G + N + chunk)
        x = torch.randn((b, S, H, P), generator=gen).to(card, torch.bfloat16)
        dt = (torch.rand((b, S, H), generator=gen) * 0.5 + 0.1).to(card)
        A = (-torch.rand(H, generator=gen) - 0.2).to(card)
        Bm, Cm = (torch.randn((b, S, G, N), generator=gen).to(
            card, torch.bfloat16) for _ in range(2))
    assert sb.variant(x.dtype, P, N, min(chunk, S)) == "wgmma"
    before = dict(sb.LAUNCHES_BY_VARIANT)
    y, st = sops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert sb.LAUNCHES_BY_VARIANT == {**before, "wgmma": before["wgmma"] + 1}
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, chunk=min(chunk, S))
    assert float(yr.float().abs().max()) > 0.0
    torch.testing.assert_close(y.float(), yr.float(), atol=2e-3,
                               rtol=BF16_RTOL)
    torch.testing.assert_close(st.float(), sr.float(), atol=2e-3,
                               rtol=BF16_RTOL)


def test_ssd_variant_sends_bf16_to_wgmma_and_float32_to_scalar(card):
    """The same inputs in bf16 and in float32: one call each, counted under
    its variant; the two kernels agree within the bf16 limit."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    x, dt, A, Bm, Cm = _ssd_model_like(card, 1, 1, 512, 8, 64, 1, 128)
    before = dict(sb.LAUNCHES_BY_VARIANT)
    y16, s16 = sb.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=256)
    assert sb.LAUNCHES_BY_VARIANT == {**before, "wgmma": before["wgmma"] + 1}
    y32, s32 = sb.ssd_scan_cuda(x.float(), dt, A, Bm.float(), Cm.float(),
                                chunk=256)
    torch.cuda.synchronize()
    assert sb.LAUNCHES_BY_VARIANT == {**before, "wgmma": before["wgmma"] + 1,
                                      "scalar": before["scalar"] + 1}
    assert y16.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert sb.KERNELS_PER_CALL == dict(wgmma=3, scalar=1, wgmma_final=2,
                                       scalar_final=1)
    torch.testing.assert_close(y16.float(), y32, atol=2e-3, rtol=BF16_RTOL)
    torch.testing.assert_close(s16.float(), s32, atol=2e-3, rtol=BF16_RTOL)


def test_ssd_kernel_rejects_bad_inputs(card):
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    x = torch.zeros((1, 8, 4, 16), device=card)
    dt = torch.zeros((1, 8, 4), device=card)
    A = torch.zeros(4, device=card)
    Bm = torch.zeros((1, 8, 2, 8), device=card)
    with pytest.raises(TypeError):
        sb.ssd_scan_cuda(x, dt.double(), A, Bm, Bm)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 8, 4, 80), device=card)
        sb.ssd_scan_cuda(big, dt, A, Bm, Bm)
    with pytest.raises(ValueError, match="unsupported"):
        sb.ssd_scan_cuda(x, dt, A, Bm[:, :, :1].expand(1, 8, 3, 8)
                         .contiguous(), Bm[:, :, :1].expand(1, 8, 3, 8)
                         .contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        sb.ssd_scan_cuda(x.transpose(1, 2), dt, A, Bm, Bm)
    # The wgmma kernel: refused for an address TMA cannot read; never
    # passed on to the scalar kernel.
    shape = (1, 64, 4, 64)
    flat = torch.zeros(64 * 4 * 64 + 1, dtype=torch.bfloat16, device=card)
    xm = flat[1:].view(shape)
    Bw = torch.zeros((1, 64, 1, 128), dtype=torch.bfloat16, device=card)
    before = dict(sb.LAUNCHES_BY_VARIANT)
    with pytest.raises(ValueError, match="aligned"):
        sb.ssd_scan_cuda(xm, torch.zeros((1, 64, 4), device=card),
                         torch.zeros(4, device=card), Bw, Bw, chunk=64)
    assert sb.LAUNCHES_BY_VARIANT == before


def _ssd_draw(card, seed, b, S, H, P, G, N, dtype):
    """test_ssd_scan_sweep's draws on the CPU, copied: x, B, C standard
    normal in ``dtype``, dt in [0.1, 0.6), A in (-1.2, -0.2]; and an
    initial state h0 [b, H, P, N], float32 standard normal."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, S, H, P), generator=gen).to(card, dtype)
    dt = (torch.rand((b, S, H), generator=gen) * 0.5 + 0.1).to(card)
    A = (-torch.rand(H, generator=gen) - 0.2).to(card)
    Bm, Cm = (torch.randn((b, S, G, N), generator=gen).to(card, dtype)
              for _ in range(2))
    h0 = torch.randn((b, H, P, N), generator=gen).to(card)
    return [x, dt, A, Bm, Cm], h0


# (b, S, H, P, G, N, chunk, dtype): the wgmma kernel (bf16, P 64) with one
# and several chunks, a ragged S and G 2; the scalar kernel in float32
# and in bf16 at a chunk the wgmma kernel does not take.
SSD_H0_CASES = [(1, 256, 8, 64, 1, 128, 256, torch.bfloat16),
                (1, 600, 8, 64, 1, 128, 256, torch.bfloat16),
                (2, 300, 8, 64, 2, 64, 64, torch.bfloat16),
                (2, 100, 4, 16, 2, 8, 16, torch.float32),
                (2, 160, 4, 32, 2, 64, 64, torch.bfloat16)]


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", SSD_H0_CASES)
def test_ssd_h0_matches_plain_on_card(card, b, S, H, P, G, N, chunk, dtype):
    """Both SSD kernels from an initial state h0 against the plain
    chunked version with the same ``init_state``, within the SSD's limits
    (2e-3, and one bf16 step of |ref| in bf16), on y and the state; one
    call of the variant, counted as a call from a state. The float32
    final of the ``ssd_final_cuda`` entry (launches 1 and 2; the scalar
    walk for the state alone) against the plain final from zero
    (``ssd_final_ref``) at the same limits, counted apart."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    from repro_torch.kernels.ssd_scan.ref import ssd_final_ref, ssd_ref
    args, h0 = _ssd_draw(card, S + H + N, b, S, H, P, G, N, dtype)
    L = min(chunk, S)
    kind = sb.variant(dtype, P, N, L)
    before = (dict(sb.LAUNCHES_BY_VARIANT), dict(sb.LAUNCHES_FROM_STATE))
    y, st = sb.ssd_scan_cuda(*args, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert sb.LAUNCHES_BY_VARIANT == {**before[0], kind: before[0][kind] + 1}
    assert sb.LAUNCHES_FROM_STATE == {**before[1], kind: before[1][kind] + 1}
    assert st.dtype == dtype
    yr, sr = ssd_ref(*args, chunk=L, init_state=h0)
    rtol = 0 if dtype == torch.float32 else BF16_RTOL
    for got, want in ((y, yr), (st, sr)):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                                   rtol=rtol)
    y0, _ = sb.ssd_scan_cuda(*args, chunk=chunk)
    assert float((y0.float() - y.float()).abs().max()) > 1e-2
    final = sb.ssd_final_cuda(*args, chunk=chunk)
    assert final.dtype == torch.float32
    torch.testing.assert_close(final, ssd_final_ref(*args, chunk=L),
                               atol=2e-3, rtol=rtol)
    assert sb.LAUNCHES_BY_VARIANT[f"{kind}_final"] == \
        before[0][f"{kind}_final"] + 1


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype,head", [
    (1, 1100, 8, 64, 1, 128, 256, torch.bfloat16, 768),
    (2, 300, 8, 64, 2, 64, 64, torch.bfloat16, 128),
    (2, 100, 4, 16, 2, 8, 16, torch.float32, 48)])
def test_ssd_split_at_a_chunk_boundary_is_the_whole_on_card(
        card, b, S, H, P, G, N, chunk, dtype, head):
    """A sequence cut after ``head`` positions (whole chunks): the tail's
    scan from the head's float32 final (``ssd_final_cuda``) gives the
    whole scan's tail and final state bit for bit (the same chunk states,
    the same float32 pass, the same operands), the last chunk ragged."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    args, _ = _ssd_draw(card, S + head, b, S, H, P, G, N, dtype)
    cut = [(t[:, :head].contiguous(), t[:, head:].contiguous())
           if t.dim() > 1 else (t, t) for t in args]
    y, st = sb.ssd_scan_cuda(*args, chunk=chunk)
    h = sb.ssd_final_cuda(*[c[0] for c in cut], chunk=chunk)
    yt, stt = sb.ssd_scan_cuda(*[c[1] for c in cut], chunk=chunk, h0=h)
    torch.cuda.synchronize()
    assert torch.equal(yt, y[:, head:]) and torch.equal(stt, st)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", [
    (2, 192, 4, 64, 2, 64, 64, torch.bfloat16),
    (2, 100, 4, 16, 2, 8, 32, torch.float32)])
def test_ssd_wrapper_carries_h0_gradient_on_card(card, b, S, H, P, G, N,
                                                 chunk, dtype):
    """``ops.ssd_scan`` with ``h0`` under grad: one kernel call, and the
    six gradients (h0's too) equal autograd through the plain version
    with ``init_state`` within the SSD's limits."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    args, h0 = _ssd_draw(card, S + P + 1, b, S, H, P, G, N, dtype)
    gen = torch.Generator().manual_seed(S)
    wy = torch.randn((b, S, H, P), generator=gen).to(card)
    ws = torch.randn((b, H, P, N), generator=gen).to(card)

    def run(fn):
        live = [t.clone().requires_grad_(True) for t in (*args, h0)]
        y, st = fn(*live)
        loss = (y.float() * wy).sum() + (st.float() * ws).sum()
        return [y.detach(), st.detach(), *torch.autograd.grad(loss, live)]
    got = run(lambda *t: sops.ssd_scan(*t[:5], chunk=chunk, h0=t[5]))
    want = run(lambda *t: ssd_ref(*t[:5], chunk=chunk, init_state=t[5]))
    rtol = 0 if dtype == torch.float32 else BF16_RTOL
    for a, b_ in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b_.float(), atol=2e-3,
                                   rtol=rtol)


def test_ssd_kernel_rejects_bad_h0_on_card(card):
    """An h0 on the CPU, of another shape or type, or not 16-byte aligned
    is refused before a launch."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    args, h0 = _ssd_draw(card, 5, 1, 128, 4, 64, 1, 64, torch.bfloat16)
    before = dict(sb.LAUNCHES_BY_VARIANT)
    with pytest.raises(ValueError, match="h0 must be a CUDA tensor"):
        sb.ssd_scan_cuda(*args, chunk=64, h0=h0.cpu())
    with pytest.raises(TypeError, match="h0 must be torch.float32"):
        sb.ssd_scan_cuda(*args, chunk=64, h0=h0.bfloat16())
    with pytest.raises(ValueError, match="h0"):
        sb.ssd_scan_cuda(*args, chunk=64, h0=h0[:, :2].contiguous())
    flat = torch.zeros(h0.numel() + 1, device=card)
    with pytest.raises(ValueError, match="aligned"):
        sb.ssd_scan_cuda(*args, chunk=64, h0=flat[1:].view(h0.shape))
    assert sb.LAUNCHES_BY_VARIANT == before


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "mamba2_2_7b"])
def test_server_on_card_goes_through_kernels(card, arch):
    """Reduced config, float32, weights drawn on the CPU and copied: the
    card's ``Server.generate`` launches one kernel per layer in its
    prefill and gives the CPU's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    from repro_torch.models import ssm
    from repro_torch.models.model import Model, to_device
    from repro_torch.runtime.serve_loop import Server
    cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                 param_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    if cfg.ssm:
        rng = np.random.default_rng(0)
        for lp in params["layers"]:
            lp["mixer"].update({k: torch.from_numpy(v) for k, v in
                                ssm.draw_live_mixer(rng, cfg).items()})
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
    before = (fb.LAUNCHES, sb.LAUNCHES)
    out = Server(model, to_device(params, card)).generate(dict(tokens=toks),
                                                          max_new=4)
    launched = (fb.LAUNCHES - before[0], sb.LAUNCHES - before[1])
    assert launched == ((0, cfg.n_layers) if cfg.ssm else (cfg.n_layers, 0))
    host = Server(model, params, device="cpu").generate(dict(tokens=toks),
                                                        max_new=4)
    np.testing.assert_array_equal(out, host)


def test_registry_builds_fused_pipeline_on_card(card):
    """A spec string with no device builds a pipeline on the card, and one
    round of it is one annealed Sinkhorn launch."""
    from repro_torch import policy
    from repro_torch.core import problem, telemetry
    from repro_torch.runtime import platform
    tele = telemetry.generate(days=2, seed=0)
    sched = policy.build("waterwise[backend=fused]", tele)
    assert sched.backend == "fused"
    assert platform.device(sched.device).type == "cuda"
    jobs = [problem.Job(job_id=i, home_region=i % 5, submit_time_s=0.0,
                        exec_time_s=600.0, energy_kwh=0.05, tolerance=1.0)
            for i in range(12)]
    before = (sinkhorn.ANNEAL_LAUNCHES, sinkhorn.LAUNCHES)
    dec = sched.schedule(jobs, 0.0, np.full(5, 4))
    assert (sinkhorn.ANNEAL_LAUNCHES - before[0],
            sinkhorn.LAUNCHES - before[1]) == (1, 0)
    assert dec.solver.backend == "fused" and len(dec.scheduled) == 12


def test_process_plan_on_card_equals_serial(card):
    """Two cells in spawned workers on the card: the serial rows on every
    column but the wall times."""
    from repro_torch import experiments
    plan = experiments.ExperimentPlan.build(
        ["nominal[days=0.01,jobs_per_day=20000,seed=2]"],
        ["baseline", "waterwise[backend=fused]"])
    serial = plan.run("serial")
    proc = plan.run("process[max_workers=2]")

    def strip(rows):
        return [{k: v for k, v in r.items()
                 if k not in ("wall_s", "mean_solve_ms")} for r in rows]
    assert all(r["error"] == "" for r in serial + proc), serial + proc
    assert strip(proc) == strip(serial)


# --- Many cells in one launch: the device executor's path --------------------

def _cells(card, B, M, N, seed):
    rng = np.random.default_rng(seed)
    C = torch.from_numpy(rng.random((B, M, N)).astype(np.float32)).to(card)
    log_a = torch.full((B, M), -float(np.log(M)), device=card)
    b = rng.random((B, N)) + 0.5
    log_b = torch.from_numpy(np.log(b / b.sum(1, keepdims=True))
                             .astype(np.float32)).to(card)
    return C, log_a, log_b


@pytest.mark.parametrize("B,M,N", [(1, 512, 6), (3, 512, 6), (8, 512, 6),
                                   (3, 4096, 6), (8, 512, 40), (5, 4, 41)])
def test_batched_anneal_is_bitwise_single_launches(card, B, M, N):
    """The cell-batched launch against one ``sinkhorn_anneal`` launch a
    cell: f and g bit for bit (one kernel, blockIdx.y the cell); and within
    ATOL of the plain batched loop."""
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_batched_ref
    C, log_a, log_b = _cells(card, B, M, N, seed=B * M + N)
    table = ops.eps_table(0.5, 0.005, 6)
    before = (sinkhorn.ANNEAL_LAUNCHES, sinkhorn.ANNEAL_BATCHED_LAUNCHES)
    f_b, g_b = ops.sinkhorn_solve_batched(C, log_a, log_b, table, 60)
    torch.cuda.synchronize()
    assert (sinkhorn.ANNEAL_LAUNCHES,
            sinkhorn.ANNEAL_BATCHED_LAUNCHES) == (before[0], before[1] + 1)
    for b in range(B):
        f, g = sinkhorn.sinkhorn_solve_cuda(C[b], log_a[b], log_b[b],
                                            table, 60)
        assert torch.equal(f_b[b], f) and torch.equal(g_b[b], g)
    f_r, g_r = sinkhorn_solve_batched_ref(C, log_a, log_b, table, 60)
    assert (f_b - f_r).abs().max().item() <= ATOL
    assert (g_b - g_r).abs().max().item() <= ATOL


def test_batched_anneal_splits_a_group_that_cannot_be_coresident(card):
    """20 cells at bucket 16384 (64 blocks each) exceed what the card holds
    at once: the wrapper splits them into several launches of as many as
    fit, by the library's own count, and no cell's bits change."""
    B, M, N = 20, 16384, 6
    C, log_a, log_b = _cells(card, B, M, N, seed=11)
    table = ops.eps_table(0.5, 0.005, 6)
    fit = sinkhorn.max_blocks(N, C.device) // (M // sinkhorn.rows_per_block())
    assert 1 <= fit < B
    before = sinkhorn.ANNEAL_BATCHED_LAUNCHES
    f_b, g_b = ops.sinkhorn_solve_batched(C, log_a, log_b, table, 60)
    torch.cuda.synchronize()
    assert sinkhorn.ANNEAL_BATCHED_LAUNCHES - before == -(-B // fit)
    for b in (0, fit - 1, fit, B - 1):
        f, g = sinkhorn.sinkhorn_solve_cuda(C[b], log_a[b], log_b[b],
                                            table, 60)
        assert torch.equal(f_b[b], f) and torch.equal(g_b[b], g)


def test_batched_anneal_rejects_bad_inputs(card):
    C, log_a, log_b = _cells(card, 2, 128, 6, seed=1)
    table = ops.eps_table(0.5, 0.005, 6)
    with pytest.raises(ValueError, match="shape"):
        sinkhorn.sinkhorn_solve_batched_cuda(C[0], log_a, log_b, table, 60)
    with pytest.raises(ValueError, match="shape"):
        sinkhorn.sinkhorn_solve_batched_cuda(C, log_a[:1], log_b, table, 60)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn.sinkhorn_solve_batched_cuda(
            C.transpose(1, 2).contiguous().transpose(1, 2), log_a, log_b,
            table, 60)
    with pytest.raises(TypeError):
        sinkhorn.sinkhorn_solve_batched_cuda(C.double(), log_a.double(),
                                             log_b.double(), table, 60)


def test_round_batch_on_card_makes_one_batched_launch_a_group(card):
    """``fused_round_batch`` on the card: one cell-batched launch per
    (bucket, statics) group and no single-cell launch; every cell's
    decisions bitwise those of its own ``fused_solve`` on the card."""
    rng = np.random.default_rng(8)
    reqs = []
    for k in range(6):          # buckets 16 and 32, hard and soft: 4 groups
        M, N = 10 + 3 * k, 6
        cost = rng.uniform(1.0, 5.0, (M, N))
        allowed = rng.random((M, N)) > 0.2
        allowed[:, 0] = True
        reqs.append(port_round.SolveRequest(
            cost=cost, allowed=allowed, capacity=np.full(N, M, np.int64),
            soften=bool(k % 2), overrun=rng.uniform(0.0, 2.0, (M, N)),
            tol=rng.uniform(0.0, 1.0, M), sigma=8.0))
    groups = len(port_round.group_requests(reqs))
    before = (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES,
              sinkhorn.ANNEAL_BATCHED_LAUNCHES)
    out = port_round.fused_round_batch(reqs)
    assert (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES,
            sinkhorn.ANNEAL_BATCHED_LAUNCHES) == (before[0], before[1],
                                                  before[2] + groups)
    for r, b in zip(reqs, out):
        single = port_round.fused_solve(
            r.cost, r.allowed, r.capacity, soften=r.soften,
            overrun=r.overrun, tol=r.tol, sigma=r.sigma)
        assert (b.status, b.objective) == (single.status, single.objective)
        np.testing.assert_array_equal(b.assign, single.assign)
    with pytest.raises(ValueError, match="exceeds"):
        port_round.fused_round_batch(reqs,
                                     devices=torch.cuda.device_count() + 1)


def test_device_plan_on_card_equals_serial(card):
    """Two seeds of ``waterwise[backend=fused]`` and a rule scheduler
    through the ``device`` executor on the card: the serial rows on every
    column but the wall times, the fused cells' solves through
    cell-batched launches only."""
    from repro_torch import experiments
    plan = experiments.ExperimentPlan.build(
        ["nominal[days=0.01,jobs_per_day=20000,seed=2]"],
        ["baseline", "waterwise[backend=fused]"], seeds=[0, 1])
    serial = plan.run("serial")
    before = (sinkhorn.ANNEAL_LAUNCHES, sinkhorn.ANNEAL_BATCHED_LAUNCHES)
    device = plan.run("device")
    assert sinkhorn.ANNEAL_LAUNCHES == before[0]
    assert sinkhorn.ANNEAL_BATCHED_LAUNCHES > before[1]

    def strip(rows):
        return [{k: v for k, v in r.items()
                 if k not in ("wall_s", "mean_solve_ms")} for r in rows]
    assert all(r["error"] == "" for r in serial + device), serial + device
    assert strip(device) == strip(serial)


# --- The warm-started solve with a convergence exit: the live service --------

def _adaptive_inputs(card, M, N, seed, drift=0.0):
    """A prepared round at M rows (forbidden arcs at BIG, the dummy row):
    (C, log_a, log_b) on the card; ``drift`` perturbs the raw costs."""
    rng = np.random.default_rng(seed)
    jobs = M - 1
    cost = rng.random((jobs, N)) * 10
    allowed = rng.random((jobs, N)) > 0.2
    allowed[np.arange(jobs), rng.integers(0, N, jobs)] = True
    noise = np.random.default_rng(seed + 1).standard_normal(cost.shape)
    cost = (cost * (1 + drift * noise)).astype(np.float32)
    C, log_a, log_b, _, _ = port_round._prepare_device(
        torch.from_numpy(cost).to(card), torch.from_numpy(allowed).to(card),
        torch.full((N,), float(jobs // N + 2), device=card),
        torch.ones(jobs, dtype=torch.bool, device=card))
    return C.contiguous(), log_a.contiguous(), log_b.contiguous()


def _adaptive_iteration_loop(C, log_a, log_b, g0, tol, table, iters):
    """The adaptive exit rule read on the host over launches of the
    iteration kernel: the yardstick the one-launch solve must equal."""
    tol32 = torch.tensor(tol, dtype=torch.float32)
    f, g, used = torch.zeros_like(log_a), g0, 0
    for eps in table:
        for _ in range(iters):
            f, g_new = sinkhorn.sinkhorn_iteration_cuda(C, g, log_a, log_b,
                                                        eps)
            delta = (g_new - g).abs().max()
            g, used = g_new, used + 1
            if not bool(delta.cpu() > tol32):
                break
    return f, g, used


@pytest.mark.parametrize("M,N", [(4, 6), (512, 6), (512, 40), (2048, 40)])
def test_adaptive_anneal_is_bitwise_the_iteration_loop(card, M, N):
    """The warm-started, convergence-exit launch, cold (6 stages x 60 from
    g = 0) and warm (one final-eps stage capped at 360, from the cold g, on
    a drifted instance): f, g and the iterations used equal the host loop
    of iteration launches under the same exit rule, bit for bit; f and g
    within ATOL of the plain loop; one launch a solve."""
    from repro_torch.core.solvers import torch_solver
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_adaptive_ref
    tol = torch_solver.SINKHORN_TOL
    g0 = torch.zeros(N, device=card)
    for case, eps0, stages, iters in (
            (_adaptive_inputs(card, M, N, M + N), 0.5, 6, 60),
            (_adaptive_inputs(card, M, N, M + N, drift=0.03), 0.005, 1, 360)):
        table = torch_solver.eps_schedule(eps0, 0.005, stages).tolist()
        before = (sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES, sinkhorn.ANNEAL_LAUNCHES)
        f_a, g_a, used = ops.sinkhorn_solve_adaptive(*case, g0, tol, table,
                                                     iters)
        torch.cuda.synchronize()
        assert (sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES,
                sinkhorn.ANNEAL_LAUNCHES) == (before[0] + 1, before[1])
        assert used.dtype == torch.int32 and used.device.type == "cuda"
        f_l, g_l, used_l = _adaptive_iteration_loop(*case, g0, tol, table,
                                                    iters)
        assert torch.equal(f_a, f_l) and torch.equal(g_a, g_l)
        assert int(used) == used_l and 0 < used_l <= stages * iters
        f_r, g_r, _ = sinkhorn_solve_adaptive_ref(*case, g0, tol, table,
                                                  iters)
        assert (f_a - f_r).abs().max().item() <= ATOL
        assert (g_a - g_r).abs().max().item() <= ATOL
        g0 = g_a


def test_adaptive_anneal_on_a_64_block_grid_finishes(card):
    """Bucket 16384 is a 64-block cooperative grid: every block must leave
    each stage at the same iteration, or one waits at a grid sync forever.
    Run in a child process under a timeout, so a hang fails the test; the
    child holds the launch bitwise against the iteration loop."""
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import sys, torch\n"
        "sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from test_torch_cuda import (_adaptive_inputs,\n"
        "    _adaptive_iteration_loop)\n"
        "from repro_torch.core.solvers import torch_solver\n"
        "from repro_torch.kernels.sinkhorn import ops\n"
        "card = torch.device('cuda')\n"
        "C, la, lb = _adaptive_inputs(card, 16384, 40, 7)\n"
        "g0 = torch.zeros(40, device=card)\n"
        "table = torch_solver.eps_schedule(0.5, 0.005, 6).tolist()\n"
        "f, g, used = ops.sinkhorn_solve_adaptive(C, la, lb, g0, 1e-5,\n"
        "                                         table, 60)\n"
        "torch.cuda.synchronize()\n"
        "f_l, g_l, used_l = _adaptive_iteration_loop(C, la, lb, g0, 1e-5,\n"
        "                                            table, 60)\n"
        "assert torch.equal(f, f_l) and torch.equal(g, g_l)\n"
        "assert int(used) == used_l > 0\n"
        "print('ok', used_l)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(root / "src"), str(root / "tests")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_adaptive_anneal_rejects_bad_inputs(card):
    C, log_a, log_b = _adaptive_inputs(card, 128, 6, 0)
    g0 = torch.zeros(6, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn.sinkhorn_solve_adaptive_cuda(C, log_a, log_b, g0.cpu(),
                                              1e-5, [0.005], 360)
    with pytest.raises(ValueError, match="shape"):
        sinkhorn.sinkhorn_solve_adaptive_cuda(C, log_a, log_b, g0[:5], 1e-5,
                                              [0.005], 360)
    with pytest.raises(TypeError):
        sinkhorn.sinkhorn_solve_adaptive_cuda(C, log_a, log_b, g0.double(),
                                              1e-5, [0.005], 360)
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        ops.sinkhorn_solve_adaptive(*(t.to("meta") for t in
                                      (C, log_a, log_b, g0)),
                                    1e-5, [0.005], 360)


def test_warm_round_on_card_makes_one_adaptive_launch(card):
    """``fused_temporal_round(warm_start=)`` on the card: one adaptive
    launch a round and no other Sinkhorn launch; the carry warms the next
    round; the decisions equal the CPU's plain loop on the same rounds."""
    from repro_torch.core import footprint, problem, telemetry
    tele = telemetry.generate(days=2, seed=0)
    M, S, R = 30, 8, 5
    rng = np.random.default_rng(0)
    jobs = [problem.Job(job_id=i, home_region=i % R, submit_time_s=0.0,
                        exec_time_s=600.0, energy_kwh=0.05, tolerance=4.0)
            for i in range(M)]
    server = footprint.m5_metal()
    snap = tele.at(0.0)
    inst = problem.build(jobs, tele, 0.0, np.full(R, 8), server, snap=snap)
    sig = [rng.random((M, S, R)) * k + 0.5 for k in (300, 2, 1)]
    drifted = [s * (1 + 0.03 * rng.standard_normal(s.shape)) for s in sig]
    ws, host = port_round.SinkhornWarmStart(), port_round.SinkhornWarmStart()
    for grid in (sig, drifted):
        args = (inst, 0.0, *grid, snap["pue"], snap["wsf"],
                np.arange(S) * 1800.0, server, 0.5, 0.5)
        before = (sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES, sinkhorn.ANNEAL_LAUNCHES,
                  sinkhorn.LAUNCHES)
        res = port_round.fused_temporal_round(*args, warm_start=ws)[3]
        assert (sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES - before[0],
                sinkhorn.ANNEAL_LAUNCHES - before[1],
                sinkhorn.LAUNCHES - before[2]) == (1, 0, 0)
        ref = port_round.fused_temporal_round(*args, warm_start=host,
                                              device="cpu",
                                              sinkhorn_impl="kernel")[3]
        assert res.feasible and res.status == ref.status
        np.testing.assert_array_equal(res.assign, ref.assign)
    assert len(ws.cold_iters) == len(ws.warm_iters) == 1
    assert ws.warm_iters[0] < ws.cold_iters[0]


# Flash outputs held relative to their size too, RMS(d) / RMS(plain): a
# non-causal output element over Skv keys is ~sqrt(e / Skv), so the
# absolute limits alone pass a mis-scaled or short launch (chip_smoke.py's
# FLASH_RRMS).
FLASH_RRMS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel_rms(got, ref):
    d = got.float() - ref.float()
    return float(d.square().mean().sqrt() / ref.float().square().mean()
                 .sqrt())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,D,Dv", [(1, 40, 96, 64), (1, 32, 192, 128)])
def test_mla_flash_entry_matches_plain_on_card(card, B, H, D, Dv, dtype):
    """MLA's unequal head dims (minicpm3 96/64, DeepSeek-V2 192/128) at
    S 1000 through the model-layout wrapper: in bf16 one launch of the
    wgmma kernel's own (D, Dv) instantiation on the unpadded inputs where
    they lie, in float32 one launch of the scalar kernel at the padded D;
    against the plain version at MLA's numpy scale."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    S = 1000
    gen = torch.Generator().manual_seed(D)
    q = torch.randn((B, S, H, 1, D), generator=gen).to(card, dtype)
    k = torch.randn((B, S, H, D), generator=gen).to(card, dtype)
    v = torch.randn((B, S, H, Dv), generator=gen).to(card, dtype)
    scale = 1.0 / np.sqrt(D)
    kind, Dk, Dvk = fops.kernel_call(dtype, D, Dv)
    assert (kind, Dk, Dvk) == (("wgmma", D, Dv) if dtype == torch.bfloat16
                               else ("scalar",) + (fops.padded_dim(D, Dv),)
                               * 2)
    before = dict(fb.LAUNCHES_BY_VARIANT)
    out = fops.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT == {**before, kind: before[kind] + 1}
    assert out.shape == (B, S, H, 1, Dv)
    ref = attention_ref(q[:, :, :, 0].transpose(1, 2).reshape(-1, S, D),
                        k.transpose(1, 2).reshape(-1, S, D),
                        v.transpose(1, 2).reshape(-1, S, Dv), causal=True,
                        scale=scale)
    got = out[:, :, :, 0].transpose(1, 2).reshape(-1, S, Dv)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=0 if dtype == torch.float32
                               else BF16_RTOL)
    assert _rel_rms(got, ref) < FLASH_RRMS[dtype]


def _model_layout(card, B, S, Kh, G, D, Dv, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, Kh, G, D), generator=gen).to(card, torch.bfloat16)
    k = torch.randn((B, S, Kh, D), generator=gen).to(card, torch.bfloat16)
    v = torch.randn((B, S, Kh, Dv), generator=gen).to(card, torch.bfloat16)
    return q, k, v


@pytest.mark.parametrize("Kh,G,D,Dv", [(2, 6, 128, 128), (4, 1, 96, 64),
                                       (2, 1, 192, 128)])
def test_model_layout_call_runs_only_the_flash_kernel_on_card(card, Kh, G,
                                                              D, Dv):
    """A bf16 wgmma call on the model layout makes no copy of q, k or v
    and no permute of o: the profiler sees one device kernel a call, the
    flash kernel, and nothing else (no copy, fill or permute)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v = _model_layout(card, 2, 512, Kh, G, D, Dv, seed=D + G)
    fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
    kernels = [(ev.key, ev.count) for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")
               and ev.self_device_time_total > 0]
    assert len(kernels) == 1, kernels
    name, count = kernels[0]
    assert "flash_fwd_sm90" in name and count == 3, kernels


@pytest.mark.parametrize("D,Dv", [(96, 64), (192, 128), (128, 128)])
def test_strided_view_matches_contiguous_on_card(card, D, Dv):
    """The wgmma kernel reads a strided view where it lies (q every other
    head of a wider tensor, k and v column slices of one fused kv row, as
    a fused projection would leave them) and gives its contiguous copy's
    output bit for bit, one launch each."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    gen = torch.Generator().manual_seed(D)
    B, S, Kh = 2, 300, 4
    wide_q = torch.randn((B, S, 2 * Kh, 1, D + 64), generator=gen).to(
        card, torch.bfloat16)
    kv = torch.randn((B, S, Kh, D + Dv), generator=gen).to(card,
                                                           torch.bfloat16)
    q = wide_q[:, :, ::2, :, 32:32 + D]
    k, v = kv[..., :D], kv[..., D:]
    assert not (q.is_contiguous() or k.is_contiguous()
                or v.is_contiguous())
    before = fb.LAUNCHES_BY_VARIANT["wgmma"]
    out = fops.flash_attention(q, k, v, causal=True)
    same = fops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT["wgmma"] == before + 2
    assert torch.equal(out, same)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)])
def test_pair_order_matches_plain_and_head_subsets_on_card(card, causal,
                                                           window):
    """Where every head's K and V together outgrow L2 (64 heads at MLA's
    (192, 128) over 3900 keys: 160 MB) the kernel deals pairs of q tiles
    head by head (31 tiles: the middle one has no partner). Held to the
    plain version on a few heads, and bit for bit to the same heads run
    alone (8 heads, 20 MB: the heaviest-first order), since every work
    item is computed whole by one CTA either way."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator().manual_seed(3900 + window)
    B, S, H, D, Dv = 1, 3900, 64, 192, 128
    q, k = (torch.randn((B, S, H, D), generator=gen).to(card, torch.bfloat16)
            for _ in range(2))
    v = torch.randn((B, S, H, Dv), generator=gen).to(card, torch.bfloat16)
    args = dict(causal=causal, window=window, scale=1.0 / np.sqrt(D))
    out = fb.flash_attention_cuda(q, k, v, **args)
    few = fb.flash_attention_cuda(q[:, :, :8], k[:, :, :8], v[:, :, :8],
                                  **args)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :, :8], few)
    heads = slice(56, 64)
    ref = attention_ref(*(t[0, :, heads].transpose(0, 1)
                          for t in (q, k, v)), **args)
    got = out[0, :, heads].transpose(0, 1)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=BF16_RTOL)
    assert _rel_rms(got, ref) < FLASH_RRMS[torch.bfloat16]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)])
@pytest.mark.parametrize("Kh,G,D", [(2, 6, 64), (2, 6, 128), (2, 2, 256)])
def test_model_layout_is_bitwise_the_heads_first_call_on_card(
        card, Kh, G, D, causal, window):
    """At D 64, 128 and 256 the model-layout call (the kernel reading q, k
    and v in place, writing o in place) equals the same call through
    contiguous heads-first copies ([BH, S, D], read as batch 1 with a head
    stride of S·D) bit for bit: only the addressing differs."""
    from repro_torch.kernels.flash_attention import ops as fops
    B, S = 2, 1000
    q, k, v = _model_layout(card, B, S, Kh, G, D, D, seed=D + G + window)
    args = dict(causal=causal, window=window)
    out = fops.flash_attention(q, k, v, **args)
    bh = fops.flash_attention_bh(
        q.permute(0, 2, 3, 1, 4).reshape(-1, S, D).contiguous(),
        k.transpose(1, 2).reshape(-1, S, D).contiguous(),
        v.transpose(1, 2).reshape(-1, S, D).contiguous(), group=G, **args)
    torch.cuda.synchronize()
    assert torch.equal(out.permute(0, 2, 3, 1, 4).reshape(-1, S, D), bh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Skv,group", [(300, 1000, 4), (1000, 130, 2)])
def test_noncausal_unequal_lengths_match_plain_on_card(card, Sq, Skv, group,
                                                       D, dtype):
    """Cross-attention's call: non-causal, Sq != Skv, GQA, on the kernel
    ``variant`` picks (wgmma in bf16, scalar in float32)."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    gen = torch.Generator().manual_seed(Sq + D)
    BHkv = 3
    q = torch.randn((BHkv * group, Sq, D), generator=gen).to(card, dtype)
    k, v = (torch.randn((BHkv, Skv, D), generator=gen).to(card, dtype)
            for _ in range(2))
    kind = fb.variant(dtype, D)
    before = dict(fb.LAUNCHES_BY_VARIANT)
    out = fops.flash_attention_bh(q, k, v, causal=False, group=group)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT == {**before, kind: before[kind] + 1}
    ref = flash_attention_bh_ref(q, k, v, causal=False, group=group)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=0 if dtype == torch.float32
                               else BF16_RTOL)
    assert _rel_rms(out, ref) < FLASH_RRMS[dtype]


def test_masked_prefill_with_unequal_lengths_is_refused_on_card(card):
    """A causal or sliding prefill attention with Sq != Skv raises and
    launches nothing (the kernel's mask puts both positions at 0)."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.models import attention
    q = torch.zeros((1, 64, 2, 2, 64), dtype=torch.bfloat16, device=card)
    k = torch.zeros((1, 100, 2, 64), dtype=torch.bfloat16, device=card)
    before = fb.LAUNCHES
    for kind in ("causal", "sliding"):
        with pytest.raises(ValueError, match="Sq == Skv"):
            attention.prefill_attention(q, k, k, kind=kind, window=16)
    assert fb.LAUNCHES == before


def _prefill_attention_calls(cfg) -> int:
    """Flash calls of one prefill: one per attention layer, the vision
    groups' cross layers and encdec's encoder and cross-attentions too."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    if cfg.family == "vision":
        return cfg.n_layers // cfg.cross_every * cfg.cross_every
    return cfg.n_layers


@pytest.mark.parametrize("arch", ["minicpm3_4b", "dbrx_132b",
                                  "deepseek_v2_236b", "llama_3_2_vision_11b",
                                  "seamless_m4t_large_v2"])
def test_new_arch_server_on_card_goes_through_kernels(card, arch,
                                                      monkeypatch):
    """Reduced config in bf16 (head dim 64 where it is not MLA's, so that
    every call is one the wgmma kernel takes; MLA's 24/16 pads to 64),
    weights drawn on the CPU and copied, vision gates live: the card's
    prefill makes one wgmma flash call per prefill attention and calls no
    plain version; its logits agree with the CPU's within the bf16
    tolerance, and ``Server.generate`` runs with frames or patches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import attention, transformer
    from repro_torch.models.model import Model, to_device
    from repro_torch.runtime.serve_loop import Server
    cfg = get_config(arch, reduced=True)
    if not cfg.mla:
        cfg = cfg.replace(head_dim=64)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    for g in params.get("groups", []):
        g["cross"].update({k: torch.from_numpy(v).to(cfg.params_dtype)
                           for k, v in transformer.draw_live_gates(
                               rng).items()})
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal((2, 30, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vision":
        extra["patches"] = rng.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (2, 40))
    plain = []
    for mod, name in ((attention, "blocked_attention"),
                      (fops, "flash_attention_bh_ref")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (
            plain.append(_n), _fn(*a, **kw))[1])
    card_params = to_device(params, card)
    batch = dict(tokens=torch.from_numpy(toks).to(card),
                 **{k: torch.from_numpy(v).to(card)
                    for k, v in extra.items()})
    before = dict(fb.LAUNCHES_BY_VARIANT)
    with torch.inference_mode():
        logits, _ = model.prefill(card_params, batch)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT == {
        "wgmma": before["wgmma"] + _prefill_attention_calls(cfg),
        "scalar": before["scalar"]}
    assert plain == []
    monkeypatch.undo()
    with torch.inference_mode():
        host, _ = model.prefill(params, dict(
            tokens=torch.from_numpy(toks),
            **{k: torch.from_numpy(v) for k, v in extra.items()}))
    torch.testing.assert_close(logits.float().cpu(), host.float(),
                               atol=0.15, rtol=0.1)
    out = Server(model, card_params).generate(dict(tokens=toks, **extra),
                                              max_new=4)
    assert out.shape == (2, 4) and out.min() >= 0 and out.max() < cfg.vocab


# -- distribution: the sharded path on a one-rank NCCL mesh -------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL process group (file rendezvous) and its (1, 1)
    ("data", "model") mesh on the card, torn down after this file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    path = tmp_path_factory.mktemp("nccl") / "init"
    dist.init_process_group("nccl", init_method=f"file://{path}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_world1_sharded_step_is_bitwise_on_card(nccl_mesh):
    """Reduced qwen2-72B in float32 on the card: the sharded step on the
    one-rank mesh gives the unsharded step's loss, grad_norm, parameters
    and moments bit for bit (every gather and reduction is the identity),
    its state DTensors on the card, with the same flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.models.model import Model, to_device
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.sharding import is_dtensor
    from repro_torch.runtime.train_loop import (make_train_step,
                                                shard_train_state)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2_72b", reduced=True).replace(
        dtype="float32", param_dtype="float32", block_kv=8)
    model = Model(cfg)
    params = to_device(model.init(torch.Generator().manual_seed(0)), "cuda")
    toks = torch.randint(0, cfg.vocab, (4, 21),
                         generator=torch.Generator().manual_seed(1))
    batch = dict(tokens=toks[:, :-1].cuda(), labels=toks[:, 1:].cuda())
    opt = adamw(lr=lambda s: 1e-2)
    for ga in (1, 2):
        before = dict(fb.LAUNCHES_BY_VARIANT)
        ref = make_train_step(model, opt, grad_accum=ga)(
            params, opt.init(params), batch)
        mid = dict(fb.LAUNCHES_BY_VARIANT)
        sp, so = shard_train_state(model, params, opt, nccl_mesh)
        new, state, met = make_train_step(model, opt, grad_accum=ga,
                                          mesh=nccl_mesh)(sp, so, batch)
        torch.cuda.synchronize()
        after = dict(fb.LAUNCHES_BY_VARIANT)
        assert {k: mid[k] - before[k] for k in mid} == \
            {k: after[k] - mid[k] for k in mid}
        assert mid["scalar"] - before["scalar"] == 2 * ga
        assert torch.equal(met["loss"], ref[2]["loss"])
        assert torch.equal(met["grad_norm"], ref[2]["grad_norm"])
        for a, b in zip(tree_leaves((new, state.mu, state.nu)),
                        tree_leaves((ref[0], ref[1].mu, ref[1].nu))):
            assert is_dtensor(a) and a.device.type == "cuda"
            assert torch.equal(a.to_local(), b)


def test_qwen2_72b_layer_flash_group8_matches_plain_on_card(card,
                                                            monkeypatch):
    """One qwen2-72B decoder layer at full width (d 8192, 64 query heads
    over 8 kv heads, head dim 128) in bf16: its prefill makes one wgmma
    flash launch at group 8, held against the plain version on the same
    q, k and v within phase 8's limits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import transformer
    from repro_torch.models.common import split_tree
    cfg = get_config("qwen2_72b").replace(n_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lp, _ = split_tree(transformer.decoder_layer_init(cfg, gen))
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    seen = {}
    inner = fops._flash_cuda

    def capture(q, k, v, **kw):
        o = inner(q, k, v, **kw)
        seen.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=kw, o=o)
        return o
    monkeypatch.setattr(fops, "_flash_cuda", capture)
    before = dict(fb.LAUNCHES_BY_VARIANT)
    with torch.inference_mode():
        y, _ = transformer.decoder_layer_apply(
            cfg, lp, x, torch.arange(512, device="cuda"), "prefill", None,
            None)
    torch.cuda.synchronize()
    assert fb.LAUNCHES_BY_VARIANT == dict(before,
                                          wgmma=before["wgmma"] + 1)
    assert tuple(seen["q"].shape) == (1, 512, 8, 8, 128)
    assert seen["kw"]["causal"] and torch.isfinite(y).all()
    ref = flash_attention_ref(seen["q"], seen["k"], seen["v"], **seen["kw"])
    d = seen["o"].float() - ref.float()
    assert d.abs().max().item() <= 2e-2
    assert (d.square().mean().sqrt()
            / ref.float().square().mean().sqrt()).item() <= 1e-2


def test_kernel_wrappers_refuse_dtensors_on_card(nccl_mesh):
    """Every kernel wrapper refuses a DTensor on the card with a
    ``TypeError`` naming it, before any launch."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.ssd_scan import ops as sops
    rep = [Replicate(), Replicate()]

    def dt(*shape, dtype=torch.bfloat16):
        return distribute_tensor(torch.zeros(shape, dtype=dtype,
                                             device="cuda"), nccl_mesh, rep)
    q, kv = dt(1, 64, 2, 2, 128), dt(1, 64, 2, 128)
    w = dt(1, 64, 16, dtype=torch.float32)
    C = dt(64, 6, dtype=torch.float32)
    calls = [lambda: fops.flash_attention(q, kv, kv),
             lambda: fops.flash_attention_bh(dt(4, 64, 128), dt(2, 64, 128),
                                             dt(2, 64, 128), group=2),
             lambda: sops.ssd_scan(dt(1, 64, 2, 64), dt(1, 64, 2),
                                   dt(2), dt(1, 64, 1, 64), dt(1, 64, 1, 64)),
             lambda: rops.rglru_layer(w, w, w, dt(16, dtype=torch.float32)),
             lambda: rops.rglru_scan(w, w),
             lambda: ops.sinkhorn_solve(C, dt(64, dtype=torch.float32),
                                        dt(6, dtype=torch.float32), [0.5],
                                        1)]
    before = (dict(fb.LAUNCHES_BY_VARIANT), dict(scan_binding.LAUNCHES),
              sinkhorn.LAUNCHES)
    for call in calls:
        with pytest.raises(TypeError, match="DTensor"):
            call()
    torch.cuda.synchronize()
    assert (dict(fb.LAUNCHES_BY_VARIANT), dict(scan_binding.LAUNCHES),
            sinkhorn.LAUNCHES) == before
