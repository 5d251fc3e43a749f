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
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
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
    before = sinkhorn.LAUNCHES
    res = port_round.fused_solve(cost, allowed, cap)
    assert res.feasible and res.backend == "fused"
    assert sinkhorn.LAUNCHES - before == 360 * sinkhorn.LAUNCHES_PER_ITERATION


def test_fused_round_on_card_takes_only_the_kernel(card):
    rng = np.random.default_rng(4)
    cost = rng.random((10, 5)) * 10
    allowed = np.ones((10, 5), bool)
    cap = np.full(5, 4)
    with pytest.raises(ValueError, match="CUDA device takes 'kernel'"):
        port_round.fused_solve(cost, allowed, cap, sinkhorn_impl="torch")


@pytest.mark.parametrize("B,S,W", [(64, 48, 16), (75, 48, 16), (16, 48, 16),
                                   (5, 29, 16), (2, 7, 15), (2, 128, 128)])
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
    assert scan_binding.LAUNCHES == dict(fwd=before["fwd"] + 1,
                                         bwd=before["bwd"] + 1)
    for k, r in zip(*grads):
        assert (k - r).abs().max().item() <= ATOL


def test_scan_kernel_rejects_bad_inputs(card):
    a = torch.rand(2, 7, 15, device=card)
    with pytest.raises(TypeError):
        scan_binding.rglru_scan_fwd_cuda(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        scan_binding.rglru_scan_fwd_cuda(a.transpose(1, 2).contiguous()
                                         .transpose(1, 2), a)
    with pytest.raises(ValueError, match="shape"):
        scan_binding.rglru_scan_bwd_cuda(a, a, a[:1])


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
    # conditioning pass; one backward per step.
    assert scan_binding.LAUNCHES == dict(fwd=before["fwd"] + 6,
                                         bwd=before["bwd"] + 3)
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
    before = sinkhorn.LAUNCHES
    _, _, _, res = port_round.fused_temporal_round(*args)
    assert res.feasible
    assert sinkhorn.LAUNCHES - before == 360 * sinkhorn.LAUNCHES_PER_ITERATION
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


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", [
    (2, 64, 4, 16, 2, 8, 16, torch.float32),
    (2, 128, 2, 32, 1, 16, 32, torch.float32),
    (2, 64, 8, 64, 8, 8, 64, torch.float32),
    (2, 100, 4, 16, 2, 8, 16, torch.float32),
    (1, 600, 8, 64, 1, 128, 256, torch.bfloat16),
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
    before = sb.LAUNCHES
    y, st = sops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == before + 1
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, chunk=min(chunk, S))
    rtol = 0 if dtype == torch.float32 else BF16_RTOL
    torch.testing.assert_close(y.float(), yr.float(), atol=2e-3, rtol=rtol)
    torch.testing.assert_close(st.float(), sr.float(), atol=2e-3, rtol=rtol)


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
