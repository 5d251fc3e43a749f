"""The port's attention against the JAX package's, on the same numpy
inputs: the flash kernel's plain versions (``kernels/flash_attention``)
against ``attention_ref``, ``blocked_attention`` and, at small shapes, the
Pallas kernel in interpret mode; the model's blocked twin and decode
attention against the reference's. The CUDA kernel itself is held to the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_bh
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref as
                                                     port_attention_ref,
                                                     flash_attention_bh_ref)
from repro_torch.models import attention

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# float32 on both sides, sums in other orders; bf16 outputs may round to
# neighbouring bf16 values (the reference kernel test's 2e-2).
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(arr, dtype):
    return jnp.asarray(arr, JDT[dtype]), torch.from_numpy(
        np.asarray(arr, np.float32)).to(TDT[dtype])


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


# test_flash_attention_sweep's shapes (tests/test_kernels.py).
SWEEP = [(4, 256, 64, True, 0, "float32"), (2, 512, 128, True, 0, "float32"),
         (2, 256, 64, False, 0, "float32"), (2, 512, 64, True, 100, "float32"),
         (2, 256, 128, True, 0, "bfloat16"), (1, 128, 256, True, 64, "float32")]


@pytest.mark.parametrize("BH,S,D,causal,window,dtype", SWEEP)
def test_plain_matches_attention_ref_sweep(BH, S, D, causal, window, dtype):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.standard_normal((BH, S, D)),
                                          dtype) for _ in range(3))
    ref = attention_ref(qj, kj, vj, causal=causal, window=window)
    _close(port_attention_ref(qt, kt, vt, causal=causal, window=window),
           ref, ATOL[dtype])
    _close(ops.flash_attention_bh(qt, kt, vt, causal=causal, window=window),
           ref, ATOL[dtype])


@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_matches_blocked_attention_gqa(G):
    """test_flash_attention_gqa's shapes: the model-layout wrapper (its CPU
    path) and the port's blocked twin against the reference's."""
    rng = np.random.default_rng(1)
    B, S, Kh, D = 2, 256, 2, 64
    qj, qt = _pair(rng.standard_normal((B, S, Kh, G, D)), "float32")
    kj, kt = _pair(rng.standard_normal((B, S, Kh, D)), "float32")
    vj, vt = _pair(rng.standard_normal((B, S, Kh, D)), "float32")
    ref = jattn.blocked_attention(qj, kj, vj, jnp.arange(S), jnp.arange(S),
                                  kind="causal", block_kv=128)
    _close(ops.flash_attention(qt, kt, vt), ref, 3e-5)
    pos = torch.arange(S)
    _close(attention.blocked_attention(qt, kt, vt, pos, pos, kind="causal",
                                       block_kv=128), ref, 3e-5)


# The first two keep their original ids; the D 256 cases are the head dim
# of the gemma models' calls, which the wgmma kernel now takes in bf16:
# group 2 with a window, and MQA (one kv head for four query heads).
@pytest.mark.parametrize("BH,S,D,causal,window,group,bq,dtype", [
    pytest.param(2, 64, 16, True, 0, 1, 32, "float32",
                 id="2-64-16-True-0-1-32"),
    pytest.param(4, 64, 32, True, 24, 2, 16, "float32",
                 id="4-64-32-True-24-2-16"),
    (4, 128, 256, True, 48, 2, 64, "float32"),
    (4, 128, 256, True, 48, 2, 64, "bfloat16"),
    (4, 128, 256, True, 0, 4, 32, "float32"),
    (4, 128, 256, True, 0, 4, 32, "bfloat16"),
])
def test_plain_matches_pallas_interpret(BH, S, D, causal, window, group, bq,
                                        dtype):
    """The port's plain version (directly and through ``ops``' CPU branch)
    against the Pallas kernel in interpret mode: float32 within 2e-5 (sums
    in other orders), bf16 within the reference kernel tests' 2e-2 (both
    compute in float32 and round the output to bf16 on their own)."""
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng.standard_normal((BH, S, D)), dtype)
    kj, kt = _pair(rng.standard_normal((BH // group, S, D)), dtype)
    vj, vt = _pair(rng.standard_normal((BH // group, S, D)), dtype)
    ref = flash_attention_bh(qj, kj, vj, causal=causal, window=window,
                             bq=bq, bk=bq, group=group, interpret=True)
    assert ref.dtype == JDT[dtype]
    _close(ops.flash_attention_bh(qt, kt, vt, causal=causal, window=window,
                                  group=group), ref, ATOL[dtype])
    _close(flash_attention_bh_ref(qt, kt, vt, causal=causal, window=window,
                                  group=group), ref, ATOL[dtype])


@pytest.mark.parametrize("kind,window", [("causal", 0), ("sliding", 24)])
def test_ragged_sequence(kind, window):
    """S = 100 against the reference's blocked attention with 32-key
    blocks (its last block padded with kv_pos = -1), for the kernel's
    plain version and the port's blocked twin."""
    rng = np.random.default_rng(3)
    B, S, Kh, G, D = 1, 100, 2, 3, 16
    qj, qt = _pair(rng.standard_normal((B, S, Kh, G, D)), "float32")
    kj, kt = _pair(rng.standard_normal((B, S, Kh, D)), "float32")
    vj, vt = _pair(rng.standard_normal((B, S, Kh, D)), "float32")
    ref = jattn.blocked_attention(qj, kj, vj, jnp.arange(S), jnp.arange(S),
                                  kind=kind, window=window, block_kv=32)
    pos = torch.arange(S)
    _close(attention.blocked_attention(qt, kt, vt, pos, pos, kind=kind,
                                       window=window, block_kv=32), ref, 3e-5)
    _close(ops.flash_attention(qt, kt, vt, window=window), ref, 3e-5)


@pytest.mark.parametrize("dtype,scale", [("float32", None),
                                         ("bfloat16", None),
                                         ("bfloat16", 0.3)])
def test_blocked_attention_scale_promotion(dtype, scale):
    """The reference scales q by a numpy float64 by default (promoting bf16
    q to float32) and by a weakly typed Python float otherwise (scaling in
    bf16); the port follows both."""
    rng = np.random.default_rng(4)
    B, S, Kh, G, D = 2, 48, 1, 2, 16
    qj, qt = _pair(rng.standard_normal((B, S, Kh, G, D)) * 3, dtype)
    kj, kt = _pair(rng.standard_normal((B, S, Kh, D)), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, Kh, D)), dtype)
    ref = jattn.blocked_attention(qj, kj, vj, jnp.arange(S), jnp.arange(S),
                                  block_kv=16, softmax_scale=scale)
    pos = torch.arange(S)
    port = attention.blocked_attention(qt, kt, vt, pos, pos, block_kv=16,
                                       softmax_scale=scale)
    _close(port, ref, ATOL[dtype] if dtype == "bfloat16" else 3e-5)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(5)
    B, Smax, Kh, G, D, pos = 2, 40, 2, 3, 16, 29
    qj, qt = _pair(rng.standard_normal((B, 1, Kh, G, D)), "float32")
    kj, kt = _pair(rng.standard_normal((B, Smax, Kh, D)), "float32")
    vj, vt = _pair(rng.standard_normal((B, Smax, Kh, D)), "float32")
    for kind, window in (("causal", 0), ("sliding", 8), ("full", 0)):
        ref = jattn.decode_attention(qj, kj, vj, pos, kind=kind,
                                     window=window)
        _close(attention.decode_attention(qt, kt, vt, pos, kind=kind,
                                          window=window), ref, 3e-6)


def test_mask_bias_matches_reference():
    qp, kp = np.arange(12), np.array([-1, 0, 3, 5, 9, 11, 14])
    for kind in ("causal", "sliding", "full"):
        ref = jattn.mask_bias(jnp.asarray(qp), jnp.asarray(kp), kind, 4)
        port = attention.mask_bias(torch.from_numpy(qp),
                                   torch.from_numpy(kp), kind, 4)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_wrapper_raises_off_cpu_and_cuda():
    q = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        ops.flash_attention_bh(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_variant_choice(dtype, D):
    """bf16 at D 64, 128 and 256 takes the wgmma kernel; float32 at every
    D, and bf16 at D 16, keep the scalar kernel."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    want = ("wgmma" if dtype == torch.bfloat16 and D in (64, 128, 256)
            else "scalar")
    assert fb.variant(dtype, D) == want
    q = torch.zeros((2, 8, D), dtype=dtype)
    assert fb.check_inputs(q, q[:1].contiguous(), q[:1].contiguous(),
                           group=2) == want


def test_cuda_wrapper_refusals():
    """The launcher raises, before any build or launch, on host memory and
    on every input neither kernel takes; the wgmma kernel also refuses
    tensors that are not 16-byte aligned (its TMA loads need it)."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    q = torch.zeros((4, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_attention_bh_cuda(q, q, q)
    with pytest.raises(TypeError):
        fb.check_inputs(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="head dim"):
        fb.check_inputs(*(q[..., :48].contiguous() for _ in range(3)))
    with pytest.raises(ValueError, match="group"):
        fb.check_inputs(q, q[:3].contiguous(), q[:3].contiguous(), group=2)
    with pytest.raises(ValueError, match="contiguous"):
        fb.check_inputs(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="share one dtype"):
        fb.check_inputs(q, q.float(), q.float())
    with pytest.raises(ValueError, match="window"):
        fb.check_inputs(q, q, q, window=-1)
    with pytest.raises(ValueError, match="must both be"):
        fb.check_inputs(q, q, q[:, :32].contiguous())
    flat = torch.zeros(4 * 64 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(4, 64, 64)           # 2 bytes off alignment
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        fb.check_inputs(shifted, q, q)
    # At D 256 too (the gemma models' head dim), on k as on q.
    q256 = torch.zeros((2, 32, 256), dtype=torch.bfloat16)
    flat = torch.zeros(2 * 32 * 256 + 4, dtype=torch.bfloat16)
    shifted = flat[4:].view(2, 32, 256)          # 8 bytes off alignment
    assert fb.check_inputs(q256, q256, q256) == "wgmma"
    with pytest.raises(ValueError, match="k must be 16-byte aligned"):
        fb.check_inputs(q256, shifted, q256)
    # The scalar kernel reads with plain loads: no alignment demand.
    flat32 = torch.zeros(4 * 64 * 64 + 1)
    shifted32 = flat32[1:].view(4, 64, 64)       # 4 bytes off alignment
    assert fb.check_inputs(shifted32, q.float(), q.float()) == "scalar"


def test_kernel_wrapper_refuses_autograd():
    """The flash kernels' launchers are forward-only (the public wrappers
    carry the gradient, ``tests/test_torch_train.py``): with grad enabled
    and an input that requires grad the launcher raises, naming those
    wrappers, before any device check or launch (a CPU tensor reaches the
    refusal here); under no_grad it goes on to its device check, which
    refuses a CPU tensor."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    q = torch.zeros((2, 8, 16), requires_grad=True)
    k = torch.zeros((2, 8, 16))
    with pytest.raises(RuntimeError,
                       match=r"forward-only.*ops\.flash_attention"):
        fb.flash_attention_bh_cuda(q, k, k)
    with pytest.raises(RuntimeError, match="forward-only"):
        fb.flash_attention_bh_cuda(k, k, q)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fb.flash_attention_bh_cuda(q, k, k)


# MLA's unequal head dims (minicpm3-4B 96/64, DeepSeek-V2 192/128), on the
# wgmma kernel's own instantiations since they were padded no more.
MLA_DIMS = [(96, 64), (192, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,Dv", MLA_DIMS)
def test_mla_model_layout_matches_reference(D, Dv, dtype):
    """``ops.flash_attention`` on the model layout at MLA's head dims, S 130
    (ragged against 128-row tiles), at MLA's numpy scale 1/sqrt(D): against
    the reference's blocked attention, and against its Pallas kernel in
    interpret mode on heads-first inputs zero-padded to 128 or 256 (it
    takes one head dim) at the unpadded scale. float32 within 3e-5 (sums in
    other orders), bf16 within the reference kernel tests' 2e-2."""
    rng = np.random.default_rng(D)
    B, S, Kh, G = 2, 130, 3, 1
    qj, qt = _pair(rng.standard_normal((B, S, Kh, G, D)), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, Kh, D)), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, Kh, Dv)), dtype)
    scale = 1.0 / np.sqrt(D)
    atol = 3e-5 if dtype == "float32" else 2e-2
    out = ops.flash_attention(qt, kt, vt, causal=True, scale=scale)
    assert out.shape == (B, S, Kh, G, Dv) and out.dtype == TDT[dtype]
    ref = jattn.blocked_attention(qj, kj, vj, jnp.arange(S), jnp.arange(S),
                                  softmax_scale=scale, block_kv=64)
    _close(out, ref, atol)
    Dp = ops.padded_dim(D, Dv)

    def padded(a):                       # [B, S, Kh, (G,) d] -> [BH, S, Dp]
        a = jnp.moveaxis(a, 1, -2).reshape(-1, S, a.shape[-1])
        return jnp.pad(a, ((0, 0), (0, 0), (0, Dp - a.shape[-1])))
    pallas = flash_attention_bh(padded(qj), padded(kj), padded(vj),
                                causal=True, scale=scale, interpret=True)
    got = out[:, :, :, 0].transpose(1, 2).reshape(-1, S, Dv)
    _close(got, np.asarray(pallas, np.float32)[..., :Dv], atol)


@pytest.mark.parametrize("Dv", [16, 64, 128, 256])
@pytest.mark.parametrize("D", [16, 64, 96, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_table(dtype, D, Dv):
    """bf16 at (64, 64), (128, 128), (256, 256), (96, 64) and (192, 128)
    takes the wgmma kernel at those dims, reading the model layout; every
    other pair goes heads first, padded to ``padded_dim``, to the kernel
    ``variant`` picks there (bf16 at a padded 64-256 is wgmma again)."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    native = dtype == torch.bfloat16 and (D, Dv) in (
        (64, 64), (128, 128), (256, 256), (96, 64), (192, 128))
    assert fb.variant(dtype, D, Dv) == ("wgmma" if native else "scalar")
    Dp = max(D, Dv) if max(D, Dv) in (16, 64, 128, 256) else {
        96: 128, 192: 256}[max(D, Dv)]
    want = (("wgmma", D, Dv) if native else
            ("wgmma" if dtype == torch.bfloat16 and Dp > 16 else "scalar",
             Dp, Dp))
    assert ops.kernel_call(dtype, D, Dv) == want


def test_model_layout_refusals():
    """The wgmma kernel reads the model layout where it lies, so
    ``check_inputs`` refuses a view TMA cannot read rather than copying
    it: a head dim that is not contiguous, a stride that is not a positive
    16-byte multiple (a broadcast head among them); and an unequal pair
    with no instantiation, and the model layout in float32 (the scalar
    kernel takes heads-first [BH, S, D] only)."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    bf = torch.bfloat16
    q = torch.zeros((2, 8, 4, 96), dtype=bf)
    k = torch.zeros((2, 8, 4, 96), dtype=bf)
    v = torch.zeros((2, 8, 4, 64), dtype=bf)
    assert fb.check_inputs(q, k, v) == "wgmma"
    wide = torch.zeros((2, 8, 8, 160), dtype=bf)
    assert fb.check_inputs(wide[:, :, ::2, 32:128], k, v) == "wgmma"
    with pytest.raises(ValueError, match="head dims 128 .* and 64"):
        fb.check_inputs(*(torch.zeros((2, 8, 4, d), dtype=bf)
                          for d in (128, 128, 64)))
    with pytest.raises(ValueError, match="contiguous in its head dim"):
        fb.check_inputs(torch.zeros((2, 8, 4, 192), dtype=bf)[..., ::2], k,
                        v)
    with pytest.raises(ValueError, match="16-byte multiples"):
        fb.check_inputs(q, torch.zeros((2, 8, 4, 100), dtype=bf)[..., :96],
                        v)
    with pytest.raises(ValueError, match="16-byte multiples"):
        fb.check_inputs(q, k, torch.zeros((2, 8, 1, 64),
                                          dtype=bf).expand(2, 8, 4, 64))
    with pytest.raises(ValueError, match="scalar kernel takes"):
        fb.check_inputs(*(t.float() for t in (q, q, q)))
    with pytest.raises(ValueError, match="batch"):
        fb.check_inputs(q, k[:1], v[:1])
    with pytest.raises(ValueError, match="group"):
        fb.check_inputs(q, k[:, :, :3], v[:, :, :3])


@pytest.mark.parametrize("D,Dv", MLA_DIMS + [(128, 128)])
def test_strided_view_matches_contiguous_copy(D, Dv):
    """A strided model-layout view (q every other head of a wider tensor,
    k and v offset columns of wider rows) gives the output of its
    contiguous copy on the CPU."""
    rng = np.random.default_rng(7)
    B, S, Kh = 2, 70, 2
    wide_q = torch.from_numpy(rng.standard_normal(
        (B, S, 2 * Kh, 1, D + 32)).astype(np.float32))
    wide_kv = torch.from_numpy(rng.standard_normal(
        (B, S, Kh, D + Dv + 16)).astype(np.float32))
    q = wide_q[:, :, ::2, :, 16:16 + D]
    k, v = wide_kv[..., 8:8 + D], wide_kv[..., 8 + D:8 + D + Dv]
    assert not (q.is_contiguous() or k.is_contiguous()
                or v.is_contiguous())
    out = ops.flash_attention(q, k, v, causal=True)
    same = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    torch.testing.assert_close(out, same, rtol=0, atol=0)
