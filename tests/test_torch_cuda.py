"""The port's CUDA kernels against their plain versions on the card.

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed: ``python -m pytest -m cuda tests/test_torch_cuda.py``
on a machine with a Hopper card. Without a card every test skips."""
import numpy as np
import pytest
import torch

from repro_torch.core import round as port_round
from repro_torch.kernels.sinkhorn import ops, sinkhorn
from repro_torch.kernels.sinkhorn.ref import sinkhorn_iteration_ref

pytestmark = pytest.mark.cuda

# Kernel vs plain version, both float32 on the card.
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
