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


@pytest.mark.parametrize("BH,S,D,causal,window,group,bq", [
    (2, 64, 16, True, 0, 1, 32),
    (4, 64, 32, True, 24, 2, 16),
])
def test_plain_matches_pallas_interpret(BH, S, D, causal, window, group, bq):
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng.standard_normal((BH, S, D)), "float32")
    kj, kt = _pair(rng.standard_normal((BH // group, S, D)), "float32")
    vj, vt = _pair(rng.standard_normal((BH // group, S, D)), "float32")
    ref = flash_attention_bh(qj, kj, vj, causal=causal, window=window,
                             bq=bq, bk=bq, group=group, interpret=True)
    _close(ops.flash_attention_bh(qt, kt, vt, causal=causal, window=window,
                                  group=group), ref, 2e-5)
    _close(flash_attention_bh_ref(qt, kt, vt, causal=causal, window=window,
                                  group=group), ref, 2e-5)


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
    """bf16 at D 64 and 128 takes the wgmma kernel; float32, and D 16 and
    256, keep the scalar kernel."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    want = ("wgmma" if dtype == torch.bfloat16 and D in (64, 128)
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
    # The scalar kernel reads with plain loads: no alignment demand.
    flat32 = torch.zeros(4 * 64 * 64 + 1)
    shifted32 = flat32[1:].view(4, 64, 64)       # 4 bytes off alignment
    assert fb.check_inputs(shifted32, q.float(), q.float()) == "scalar"
