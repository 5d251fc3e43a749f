"""The port's SSD scan against the JAX package's, on the same numpy inputs:
the kernel's plain versions (``kernels/ssd_scan``: the chunked form, the
sequential recurrence and the chunk-parallel twin of the wgmma kernel)
against ``ssd_naive``, ``ssd_chunked`` and the Pallas kernel in interpret
mode; the twin with the wgmma kernel's rounding against the card's limit;
the kernels' variant rule and input checks; the Mamba-2 block's pieces
(segment sum, decode step, causal conv) against the reference's. The CUDA
kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_naive, ssd_ref
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan import ssd_scan as binding
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_parallel
from repro_torch.kernels.ssd_scan.ref import ssd_naive as port_naive
from repro_torch.kernels.ssd_scan.ref import ssd_ref as port_ref
from repro_torch.models import ssm
from repro_torch.numerics import softplus

# The reference kernel test's tolerance (float32 on both sides; the chunked
# form and the recurrence sum in other orders).
ATOL = 2e-3


def _inputs(seed, b, S, H, P, G, N):
    """test_ssd_scan_sweep's draws: x, dt in [0.1, 0.6), A in (-1.2, -0.2],
    B, C standard normal."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, S, H, P)).astype(np.float32),
            (rng.random((b, S, H)) * 0.5 + 0.1).astype(np.float32),
            (-rng.random(H) - 0.2).astype(np.float32),
            rng.standard_normal((b, S, G, N)).astype(np.float32),
            rng.standard_normal((b, S, G, N)).astype(np.float32))


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


# test_ssd_scan_sweep's shapes (tests/test_kernels.py).
SWEEP = [(64, 4, 16, 2, 8, 16), (128, 2, 32, 1, 16, 32),
         (64, 8, 64, 8, 8, 64)]


@pytest.mark.parametrize("S,H,P,G,N,chunk", SWEEP)
def test_plain_matches_naive_and_chunked_sweep(S, H, P, G, N, chunk):
    arrs = _inputs(2, 2, S, H, P, G, N)
    yn, sn = ssd_naive(*_jax(arrs))
    yc, sc = ssd_ref(*_jax(arrs), chunk=chunk)
    y, st = ops.ssd_scan(*_torch(arrs), chunk=chunk)
    _close(y, yn)
    _close(st, sn)
    _close(y, yc, 1e-4)
    _close(st, sc, 1e-4)
    y, st = port_naive(*_torch(arrs))
    _close(y, yn, 1e-4)
    _close(st, sn, 1e-4)


def test_plain_matches_pallas_interpret():
    arrs = _inputs(3, 1, 32, 2, 8, 1, 4)
    yk, sk = jax_ssd_scan(*_jax(arrs), chunk=8, interpret=True)
    y, st = ops.ssd_scan(*_torch(arrs), chunk=8)
    _close(y, yk, 1e-4)
    _close(st, sk, 1e-4)


@pytest.mark.parametrize("S,chunk", [(50, 16), (7, 16), (33, 32)])
def test_ragged_sequence_is_exact_padding(S, chunk):
    """S not a multiple of the chunk: the reference pads with dt = 0."""
    arrs = _inputs(4, 2, S, 4, 16, 2, 8)
    yc, sc = ssd_ref(*_jax(arrs), chunk=min(chunk, S))
    yn, sn = ssd_naive(*_jax(arrs))
    y, st = ops.ssd_scan(*_torch(arrs), chunk=chunk)
    _close(y, yc, 1e-4)
    _close(st, sc, 1e-4)
    _close(y, yn)
    _close(st, sn)


# The sweep's shapes, then G > 1 at P 64, a ragged S and a chunk longer
# than S.
CHUNK_PARALLEL = SWEEP + [(96, 8, 64, 2, 16, 32), (100, 4, 16, 2, 8, 16),
                          (40, 4, 16, 2, 8, 64)]


@pytest.mark.parametrize("S,H,P,G,N,chunk", CHUNK_PARALLEL)
def test_chunk_parallel_matches_reference(S, H, P, G, N, chunk):
    """The plain twin of the wgmma kernel's three stages, in float32,
    against the reference's chunked form, its recurrence and (where S is
    whole chunks, as the Pallas kernel needs) its Pallas kernel."""
    arrs = _inputs(8, 2, S, H, P, G, N)
    L = min(chunk, S)
    y, st = ssd_chunk_parallel(*_torch(arrs), chunk=chunk)
    for ref in (ssd_ref(*_jax(arrs), chunk=L), ssd_naive(*_jax(arrs))):
        _close(y, ref[0], 1e-4)
        _close(st, ref[1], 1e-4)
    if S % L == 0:
        yk, sk = jax_ssd_scan(*_jax(arrs), chunk=L, interpret=True)
        _close(y, yk, 1e-4)
        _close(st, sk, 1e-4)


def _model_like(seed, b, S, H, P, G, N):
    """Inputs as the Mamba-2 block hands them to the scan, drawn as
    ``chip_smoke.py::ssd_inputs(model_like=True)`` draws them (on the CPU
    here): x, B, C SiLU outputs of unit normals in bf16, dt and A at
    Mamba-2's init ranges."""
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
    return x, dt, A, Bm, Cm


def test_chunk_parallel_kernel_rounding_within_card_limit():
    """The twin with the operands the wgmma kernel rounds rounded as it
    does (three bf16 hi + lo pairs) stays within the limit the card holds
    the kernel to, |d| <= 2e-3 + 2^-7 |ref| on y and on the state, against
    the plain chunked version on the same bf16 inputs."""
    args = _model_like(0, 1, 1024, 16, 64, 1, 128)
    yr, sr = port_ref(*args, chunk=256)
    y, st = ssd_chunk_parallel(*args, chunk=256, rounding="kernel")
    assert y.dtype == st.dtype == torch.bfloat16
    assert float(yr.float().abs().max()) > 1.0
    for out, ref in ((y, yr), (st, sr)):
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-3,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype,P,N,L,want", [
    (torch.bfloat16, 64, 128, 256, "wgmma"),
    (torch.bfloat16, 64, 64, 64, "wgmma"),
    (torch.bfloat16, 64, 128, 192, "wgmma"),
    (torch.float32, 64, 128, 256, "scalar"),
    (torch.bfloat16, 32, 128, 256, "scalar"),
    (torch.bfloat16, 64, 96, 256, "scalar"),
    (torch.bfloat16, 64, 256, 256, "scalar"),
    (torch.bfloat16, 64, 128, 100, "scalar"),
    (torch.bfloat16, 64, 128, 512, "scalar"),
])
def test_variant_rule(dtype, P, N, L, want):
    assert binding.variant(dtype, P, N, L) == want


def test_check_inputs_picks_the_variant_and_refuses_bad_inputs():
    """Device-free: the refusals the card path raises, on CPU tensors."""
    def make(S, H, P, G, N, dtype):
        return (torch.zeros((1, S, H, P), dtype=dtype),
                torch.zeros((1, S, H)), torch.zeros(H),
                torch.zeros((1, S, G, N), dtype=dtype),
                torch.zeros((1, S, G, N), dtype=dtype))
    assert binding.check_inputs(*make(600, 8, 64, 1, 128, torch.bfloat16),
                                chunk=256) == "wgmma"
    assert binding.check_inputs(*make(600, 8, 64, 1, 128, torch.float32),
                                chunk=256) == "scalar"
    # chunk > S: chunks of S rows, not a multiple of 64 here.
    assert binding.check_inputs(*make(40, 8, 64, 1, 128, torch.bfloat16),
                                chunk=256) == "scalar"
    x, dt, A, Bm, Cm = make(64, 8, 64, 2, 128, torch.bfloat16)
    with pytest.raises(TypeError):
        binding.check_inputs(x, dt.double(), A, Bm, Cm)
    with pytest.raises(TypeError):
        binding.check_inputs(x, dt, A, Bm.float(), Cm)
    with pytest.raises(ValueError, match="contiguous"):
        binding.check_inputs(x.transpose(1, 2), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="unsupported"):
        binding.check_inputs(*make(64, 8, 64, 3, 128, torch.bfloat16))
    with pytest.raises(ValueError, match="head dim"):
        binding.check_inputs(*make(64, 8, 80, 1, 128, torch.bfloat16))
    with pytest.raises(ValueError, match="chunk"):
        binding.check_inputs(x, dt, A, Bm, Cm, chunk=0)


def test_segsum_matches_reference():
    a = np.random.default_rng(5).standard_normal((3, 12)).astype(np.float32)
    np.testing.assert_allclose(ssm._segsum(torch.from_numpy(a)).numpy(),
                               np.asarray(jssm._segsum(jnp.asarray(a))),
                               atol=1e-5)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(6)
    b, H, P, G, N = 2, 4, 8, 2, 6
    arrs = [rng.standard_normal((b, 1, H, P)).astype(np.float32),
            (rng.random((b, 1, H)) * 0.5).astype(np.float32),
            (-rng.random(H) - 0.2).astype(np.float32),
            rng.standard_normal((b, 1, G, N)).astype(np.float32),
            rng.standard_normal((b, 1, G, N)).astype(np.float32),
            rng.standard_normal((b, H, P, N)).astype(np.float32)]
    yj, sj = jssm.ssd_step(*_jax(arrs))
    y, st = ssm.ssd_step(*_torch(arrs))
    _close(y, yj, 1e-5)
    _close(st, sj, 1e-5)


def test_causal_conv_with_and_without_state():
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 5, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        yj, nj = jssm._causal_conv(*_jax([u, w, bias]),
                                   None if state is None
                                   else jnp.asarray(state))
        y, n = ssm._causal_conv(*_torch([u, w, bias]),
                                None if state is None
                                else torch.from_numpy(state))
        _close(y, yj, 1e-6)
        _close(n, nj, 0.0)


def test_live_mixer_draw_makes_the_scan_carry_signal(monkeypatch):
    """The reference's zero-init conv makes x, B and C exactly zero at the
    scan; ``draw_live_mixer`` gives a Mamba-2 block whose scan output is
    nonzero."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import dense_init, split_tree
    cfg = get_config("mamba2_2_7b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p, _ = split_tree(ssm.block_init(
        gen, cfg.d_model, d_inner=cfg.d_inner, head_dim=cfg.ssm_head_dim,
        n_groups=cfg.ssm_groups, d_state=cfg.ssm_state))
    x = dense_init(gen, (2, 24, cfg.d_model),
                   ("act_batch", "act_seq", "act_embed"), fan_in=1).value
    seen = []
    plain = ssm.ssd_chunked

    def record(*args, **kw):
        y, s = plain(*args, **kw)
        seen.append(float(y.abs().max()))
        return y, s
    monkeypatch.setattr(ssm, "ssd_chunked", record)
    ssm.block_apply(x, p, cfg, mode="prefill", chunk=cfg.ssd_chunk)
    live = dict(p, **{k: torch.from_numpy(v) for k, v in
                      ssm.draw_live_mixer(np.random.default_rng(0),
                                          cfg).items()})
    ssm.block_apply(x, live, cfg, mode="prefill", chunk=cfg.ssd_chunk)
    assert seen[0] == 0.0 and seen[1] > 1e-3


def test_kernel_launch_refuses_autograd():
    """The SSD kernels' launcher is forward-only (``ops.ssd_scan`` carries
    the gradient, ``tests/test_torch_train.py``): ``_launch``, which the
    model's path and the timing paths both reach, raises with grad enabled
    and any input that requires grad, naming that wrapper, before it
    builds or launches (CPU tensors reach the refusal here)."""
    b, S, H, P, G, N = 1, 8, 2, 16, 1, 8
    x = torch.zeros((b, S, H, P))
    dt = torch.zeros((b, S, H))
    A = torch.zeros(H)
    Bm = torch.zeros((b, S, G, N))
    for i in range(5):
        args = [x, dt, A, Bm, Bm.clone()]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError,
                           match=r"forward-only.*ops\.ssd_scan"):
            binding._launch("scalar", *args, S)


# -- the initial state (h0) and the final state from zero --------------------

def _h0(seed, b, H, P, N):
    return np.random.default_rng(seed).standard_normal(
        (b, H, P, N)).astype(np.float32)


# (S, chunk): segments of one, two and three chunks, and three with a
# ragged last chunk of 8 rows.
H0_SEGMENTS = [(16, 16), (32, 16), (48, 16), (40, 16)]


@pytest.mark.parametrize("S,chunk", H0_SEGMENTS)
def test_plain_with_h0_matches_reference(S, chunk):
    """The port's SSD from a given state against the reference's
    ``ssd_chunked(..., init_state=)`` on the same float32 inputs, at the
    tolerance of the chunked forms against each other (1e-4)."""
    arrs = _inputs(40 + S, 2, S, 4, 16, 2, 8)
    h0 = _h0(S, 2, 4, 16, 8)
    yj, sj = jssm.ssd_chunked(*_jax(arrs), chunk=chunk,
                              init_state=jnp.asarray(h0))
    y, st = ops.ssd_scan(*_torch(arrs), chunk=chunk,
                         h0=torch.from_numpy(h0))
    _close(y, yj, 1e-4)
    _close(st, sj, 1e-4)
    # the state is carried: the same call from zero differs
    y0, _ = ops.ssd_scan(*_torch(arrs), chunk=chunk)
    assert float((y - y0).abs().max()) > 1e-2


@pytest.mark.parametrize("S,chunk", [(32, 16), (40, 16)])
def test_h0_gradient_matches_jax_grad(S, chunk):
    """The gradient of a weighted sum of (y, final state) against every
    input, ``h0`` included, through the port's plain SSD against
    ``jax.grad`` of the reference's ``ssd_chunked(..., init_state=)``,
    within 1e-4 of each gradient's largest entry."""
    import jax
    b, H, P, G, N = 2, 4, 16, 2, 8
    arrs = [*_inputs(50 + S, b, S, H, P, G, N), _h0(60 + S, b, H, P, N)]
    rng = np.random.default_rng(70 + S)
    wy = rng.standard_normal((b, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((b, H, P, N)).astype(np.float32)

    def jloss(x, dt, A, Bm, Cm, h0):
        y, st = jssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=h0)
        return jnp.sum(y * wy) + jnp.sum(st * ws)
    want = jax.grad(jloss, argnums=tuple(range(6)))(*_jax(arrs))
    live = [t.requires_grad_(True) for t in _torch(arrs)]
    y, st = ops.ssd_scan(*live[:5], chunk=chunk, h0=live[5])
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(st * torch.from_numpy(ws))).backward()
    for t, w in zip(live, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    assert float(live[5].grad.abs().max()) > 0


@pytest.mark.parametrize("head,S,chunk", [(32, 48, 8), (24, 40, 8),
                                          (16, 40, 16)])
def test_split_run_from_the_heads_final_equals_the_whole(head, S, chunk):
    """A sequence cut at a chunk boundary: the tail's scan from the head's
    float32 final state (``ssd_final``) is bitwise the whole scan's tail
    (the last tail chunk ragged in the second and third cases), and its
    final state the whole scan's; ``ssd_final`` is bitwise the whole
    scan's float32 final and the float32 ``ssd_scan``'s state."""
    arrs = _torch(_inputs(80 + head, 2, S, 4, 16, 2, 8))
    head_args = [t[:, :head] if t.dim() > 1 else t for t in arrs]
    tail_args = [t[:, head:] if t.dim() > 1 else t for t in arrs]
    yw, sw = ops.ssd_scan(*arrs, chunk=chunk)
    h = ops.ssd_final(*head_args, chunk=chunk)
    assert h.dtype == torch.float32
    assert torch.equal(h, ops.ssd_scan(*head_args, chunk=chunk)[1])
    y, st = ops.ssd_scan(*tail_args, chunk=chunk, h0=h)
    assert torch.equal(y, yw[:, head:])
    assert torch.equal(st, sw)
    assert torch.equal(ops.ssd_final(*arrs, chunk=chunk), sw)


def test_final_from_zero_in_the_work_dtype():
    """``ssd_final`` hands back the state in the plain SSD's work dtype,
    float32 for bf16 and float32 inputs and float64 for float64 ones,
    equal to ``ssd_chunked``'s state before its cast to x's dtype; and
    ``chunk_decay`` is the product of the chunks' decays, within float32
    rounding of exp(sum dt A)."""
    for dtype, work in ((torch.float64, torch.float64),
                        (torch.bfloat16, torch.float32)):
        x, dt, A, Bm, Cm = (t.to(dtype) if i not in (1, 2) else t
                            for i, t in enumerate(
                                _torch(_inputs(90, 1, 40, 4, 16, 2, 8))))
        assert ssm.work_dtype(x) == work
        f = ops.ssd_final(x, dt, A, Bm, Cm, chunk=16)
        assert f.dtype == work
        _, st = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
        assert torch.equal(f.to(dtype), st)
    d = ssm.chunk_decay(dt, A, 16)
    assert d.shape == (1, 4)
    torch.testing.assert_close(d, torch.exp((dt * A).sum(1)), rtol=1e-5,
                               atol=0)


# Digests (sha256, first 16 hex digits) of (y, state) of ``ops.ssd_scan``
# without h0 on H0_NONE_CASES's fixed numpy inputs, as the plain version
# gave them before the initial state was added. (float64 inputs compute
# in float64 since, ``ssm.work_dtype``.)
H0_NONE_CASES = [(2, 40, 4, 16, 2, 8, 16, torch.float32),
                 (1, 64, 8, 64, 1, 32, 32, torch.float32),
                 (2, 50, 4, 16, 2, 8, 16, torch.bfloat16)]
H0_NONE_DIGESTS = ["c4671dea02cabd00", "13b75571216e3131",
                   "10e0a2c7fbbd74d2"]


@pytest.mark.parametrize("i", range(len(H0_NONE_CASES)))
def test_no_h0_is_bitwise_what_it_was(i):
    """``h0=None`` (and no h0 at all) gives bit for bit what the plain SSD
    gave before the initial state existed."""
    import hashlib
    b, S, H, P, G, N, chunk, dtype = H0_NONE_CASES[i]
    rng = np.random.default_rng(300 + i)
    x = torch.from_numpy(rng.standard_normal((b, S, H, P)).astype(
        np.float32)).to(dtype)
    dt = torch.from_numpy((rng.random((b, S, H)) * 0.5 + 0.1).astype(
        np.float32))
    A = torch.from_numpy((-rng.random(H) - 0.2).astype(np.float32))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((b, S, G, N)).astype(
        np.float32)).to(dtype) for _ in range(2))
    for kw in (dict(), dict(h0=None)):
        h = hashlib.sha256()
        for t in ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, **kw):
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest()[:16] == H0_NONE_DIGESTS[i]


def test_check_inputs_refuses_bad_h0():
    """Device-free: an ``h0`` of the wrong shape, dtype, device,
    layout or alignment is refused; a good one passes."""
    b, S, H, P, G, N = 1, 64, 8, 64, 1, 128
    x = torch.zeros((b, S, H, P), dtype=torch.bfloat16)
    dt, A = torch.zeros((b, S, H)), torch.zeros(H)
    Bm = torch.zeros((b, S, G, N), dtype=torch.bfloat16)
    good = torch.zeros((b, H, P, N))
    assert binding.check_inputs(x, dt, A, Bm, Bm, h0=good) == "wgmma"
    with pytest.raises(ValueError, match=r"h0 \(1, 8, 64, 64\)"):
        binding.check_inputs(x, dt, A, Bm, Bm, h0=good[..., :64]
                             .contiguous())
    with pytest.raises(ValueError, match="h0 must have 4 dimensions"):
        binding.check_inputs(x, dt, A, Bm, Bm, h0=good[0])
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="h0 must be torch.float32"):
            binding.check_inputs(x, dt, A, Bm, Bm, h0=good.to(dtype))
    with pytest.raises(ValueError, match="one device"):
        binding.check_inputs(x, dt, A, Bm, Bm,
                             h0=torch.zeros((b, H, P, N), device="meta"))
    with pytest.raises(ValueError, match="h0 must be contiguous"):
        binding.check_inputs(x, dt, A, Bm, Bm, h0=torch.zeros(
            (b, H, N, P)).transpose(2, 3))
    off = torch.zeros(b * H * P * N + 1)[1:].view(b, H, P, N)
    with pytest.raises(ValueError, match="h0 must be 16-byte aligned"):
        binding.check_inputs(x, dt, A, Bm, Bm, h0=off)


def test_launchers_refuse_h0_that_requires_grad_and_cpu_tensors():
    """The launcher is forward-only for ``h0`` too, and the card entries
    refuse a CPU ``h0`` before anything is built."""
    b, S, H, P, G, N = 1, 8, 2, 16, 1, 8
    x, dt, A = torch.zeros((b, S, H, P)), torch.zeros((b, S, H)), \
        torch.zeros(H)
    Bm = torch.zeros((b, S, G, N))
    h0 = torch.zeros((b, H, P, N), requires_grad=True)
    with pytest.raises(RuntimeError, match=r"forward-only.*ops\.ssd_scan"):
        binding._launch("scalar", x, dt, A, Bm, Bm.clone(), S, h0=h0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        binding.ssd_scan_cuda(x, dt, A, Bm, Bm, h0=h0.detach())
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        binding.ssd_final_cuda(x, dt, A, Bm, Bm)
