"""The Hopper flash-attention kernels: ctypes binding and launch.

Two kernels replace the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py::flash_attention_bh``, chosen by ``variant(dtype, D,
Dv)``:

  ``wgmma``   bf16 at (D_qk, D_v) in ``WGMMA_DIMS``: (64, 64), (128, 128),
              (256, 256) and MLA's (96, 64) and (192, 128);
              ``csrc/flash_attention_sm90.cu``, both products on the tensor
              cores (wgmma), Q, K and V read by TMA straight from the
              caller's strided layout ([B, S, H, D] at any row, head and
              batch strides that are 16-byte multiples) and O written
              into it — every bf16 LM prefill's path;
  ``scalar``  float32 at every D, and bf16 at D 16:
              ``csrc/flash_attention.cu``, scalar float32 FMAs, on
              contiguous [BH, S, D] with equal head dims.

See the notes at the top of the CUDA sources for the designs and what
bounds them. Neither falls back on the other: a call the chosen kernel
does not take raises. ``_launch("scalar", ...)`` also takes bf16 at D
64-256; timing code uses it to hold the wgmma kernel beside the scalar
one on the same inputs, and no model path reaches it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# Kernel launches made by ``flash_attention_bh_cuda`` and
# ``flash_attention_cuda`` in this process (one per call), in all and by
# variant. Plain counters, so a run can show that its main path went
# through the kernels, and which.
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"wgmma": 0, "scalar": 0}

HEAD_DIMS = (16, 64, 128, 256)
# (D_qk, D_v) pairs of the wgmma kernel's instantiations.
WGMMA_DIMS = ((64, 64), (128, 128), (256, 256), (96, 64), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# TMA reads from 16-byte aligned global addresses, at strides that are
# multiples of 16 bytes.
TMA_ALIGN = 16

_LIBS = {}


def variant(dtype: torch.dtype, D: int, Dv: int | None = None) -> str:
    """The kernel that takes a call at head dims (D, Dv) (Dv defaults to
    D): ``"wgmma"`` for bf16 at a pair in ``WGMMA_DIMS``, else
    ``"scalar"``."""
    Dv = D if Dv is None else Dv
    return ("wgmma" if dtype == torch.bfloat16 and (D, Dv) in WGMMA_DIMS
            else "scalar")


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "scalar":
            lib = _build.library("flash_attention")
            fn = lib.flash_attention_fwd
            fn.argtypes = [ptr] * 4 + [i32] * 9 + [ctypes.c_float, ptr]
        else:
            lib = _build.library("flash_attention_sm90")
            fn = lib.flash_attention_fwd_sm90_strided
            fn.argtypes = ([ptr] * 4 + [i32] * 7 + [ptr, i32, i32, i32,
                                                    ctypes.c_float, ptr])
        fn.restype = i32
        _LIBS[name] = lib
    return lib


def _bshd(t: torch.Tensor) -> tuple:
    """(shape, strides) of ``t`` as [B, S, H, D], the layout the wgmma
    kernel reads: the model layout as it is, the kernel layout [BH, S, D]
    as batch 1 with heads at a stride of S·D (its batch stride the span,
    never stepped along). Tuples only: no view is made (host time a call
    matters where the kernel takes tens of microseconds)."""
    shape, st = t.shape, t.stride()
    if len(shape) == 3:
        return ((1, shape[1], shape[0], shape[2]),
                (shape[0] * st[0], st[1], st[0], st[2]))
    return tuple(shape), st


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 group: int | None = None, window: int = 0,
                 q_offset: int = 0) -> str:
    """Raise on what neither kernel takes; return the variant that takes
    the rest. q, k and v are all the kernel layout [BH, S, D] (heads
    first; ``group`` query heads a kv head, default BHq / BHkv) or all the
    model layout [B, S, H, D] (the wgmma kernel only). v's head dim may
    differ from q's and k's at a pair in ``WGMMA_DIMS``. The wgmma kernel
    takes any strides whose last is 1 and whose others are positive
    16-byte multiples, on 16-byte aligned bases; the scalar kernel
    contiguous [BH, S, D] at one head dim in ``HEAD_DIMS``. Device-free,
    so that the CPU tests reach every refusal."""
    nd = q.dim()
    if nd not in (3, 4):
        raise ValueError(f"q must be [BH, S, D] or [B, S, H, D], got shape "
                         f"{tuple(q.shape)}")
    layout = "[BH, S, D]" if nd == 3 else "[B, S, H, D]"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != nd:
            raise ValueError(f"{name} must be {layout} like q, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share one dtype and device")
    (B, Sq, Hq, D), q_st = _bshd(q)
    (Bk, Skv, Hkv, Dk), k_st = _bshd(k)
    v_shape, v_st = _bshd(v)
    Dv = v_shape[3]
    if Dk != D or v_shape[:3] != (Bk, Skv, Hkv):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be {layout} over q's batch, with k at q's "
                         f"head dim {D}")
    if Bk != B:
        raise ValueError(f"q's batch {B} and k's {Bk} differ")
    if min(B, Sq, Skv, Hkv) < 1 or max(q.numel(), k.numel(),
                                       v.numel()) >= 2 ** 31:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if group is None:
        group = max(Hq // Hkv, 1)
    if group < 1 or Hq != Hkv * group:
        heads = "BH" if nd == 3 else "H"
        raise ValueError(f"{heads}q {Hq} != {heads}kv {Hkv} * group "
                         f"{group}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    kind = variant(q.dtype, D, Dv)
    if kind == "scalar":
        if D not in HEAD_DIMS or Dv != D:
            pairs = ", ".join(f"{a}/{b}" for a, b in WGMMA_DIMS)
            raise ValueError(
                f"head dims {D} (q, k) and {Dv} (v) in {q.dtype}: the "
                f"scalar kernel takes one head dim in {HEAD_DIMS}, the "
                f"wgmma kernel bf16 at {pairs}")
        if nd != 3:
            raise ValueError(f"the scalar kernel takes [BH, S, D]; got "
                             f"{q.dtype} in the model layout")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        return kind
    step = TMA_ALIGN // 2                   # bf16 elements in 16 bytes
    for name, t, shape, st in (("q", q, (B, Sq, Hq), q_st),
                               ("k", k, (B, Skv, Hkv), k_st),
                               ("v", v, (B, Skv, Hkv), v_st)):
        if st[3] != 1:
            raise ValueError(
                f"{name} must be contiguous in its head dim (stride 1) for "
                f"the wgmma kernel's TMA loads, got strides {t.stride()}")
        if any(n > 1 and (s < 1 or s % step) for n, s in zip(shape, st)):
            raise ValueError(
                f"{name}'s strides {t.stride()} must be positive "
                f"{TMA_ALIGN}-byte multiples for the wgmma kernel's TMA "
                f"loads")
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name} must be {TMA_ALIGN}-byte aligned "
                             f"for the TMA loads of the wgmma kernel")
    return kind


def _refuse_grad(q, k, v) -> None:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "the flash kernels' launchers are forward-only: an input "
            "requires grad, and their output would carry no gradient. "
            "ops.flash_attention and ops.flash_attention_bh carry it (the "
            "kernel forward, the plain version's backward); call those, or "
            "this under torch.no_grad() or with detached inputs")


def _on_card(q, k, v) -> None:
    _refuse_grad(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def flash_attention_bh_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, scale=None, group: int = 1,
                            q_offset: int = 0) -> torch.Tensor:
    """q: [BHq, Sq, D]; k: [BHkv, Skv, D]; v: [BHkv, Skv, Dv] with BHq =
    BHkv * group, on the card. Returns [BHq, Sq, Dv] in q's dtype. Head
    ``h`` attends kv head ``h // group``; ``scale`` defaults to 1/sqrt(D)
    (the scalar kernel applies it to q in float32, the wgmma kernel to the
    float32 scores); query row ``i`` sits at position ``q_offset + i`` of
    the keys' (the causal and window masks' offset). Forward only: raises
    when grad is enabled and an input requires it
    (``ops.flash_attention_bh`` differentiates)."""
    _on_card(q, k, v)
    kind = check_inputs(q, k, v, group=group, window=window,
                        q_offset=q_offset)
    return _launch(kind, q, k, v, causal=causal, window=window, scale=scale,
                   group=group, q_offset=q_offset)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale=None, q_offset: int = 0) -> torch.Tensor:
    """The model layout on the card, read and written in place by the
    wgmma kernel: q [B, Sq, Hq, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv,
    Dv] at any strides ``check_inputs`` takes (no copy is made) -> o [B,
    Sq, Hq, Dv], contiguous. Query head ``h`` attends kv head ``h //
    (Hq / Hkv)``; ``scale`` defaults to 1/sqrt(D); query row ``i`` sits at
    key position ``q_offset + i``. Raises on what the
    wgmma kernel does not take (float32 and other head dims go through
    ``ops.flash_attention``'s heads-first path)."""
    _on_card(q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got shape "
                         f"{tuple(q.shape)}")
    kind = check_inputs(q, k, v, window=window, q_offset=q_offset)
    return _launch(kind, q, k, v, causal=causal, window=window, scale=scale,
                   group=q.shape[2] // k.shape[2], q_offset=q_offset)


def _strides(t: torch.Tensor) -> list:
    """(batch, row, head) element strides of ``t`` as ``_bshd`` reads it;
    a dim of size 1 (never stepped along) gets the tensor's span rounded
    up to 16 bytes, a valid TMA stride whatever torch keeps there."""
    shape, st = _bshd(t)
    out = list(st[:3])
    if 1 in shape[:3]:
        span = 1 + sum((n - 1) * s for n, s in zip(shape, st))
        span = -(-span // 8) * 8
        out = [s if n > 1 else span for n, s in zip(shape[:3], out)]
    return out


def _launch(kind: str, q, k, v, *, causal: bool, window: int, scale,
            group: int, q_offset: int = 0) -> torch.Tensor:
    """One call of the ``kind`` kernel on CUDA inputs that ``check_inputs``
    passed: [BH, S, D] (both kernels) or [B, S, H, D] (wgmma). The scalar
    kernel takes every [BH, S, D] call, so timing code may hand it a call
    the wgmma kernel would take."""
    global LAUNCHES
    _refuse_grad(q, k, v)
    D, Dv = q.shape[-1], v.shape[-1]
    scale = float(np.float32(scale if scale is not None
                             else 1.0 / np.sqrt(D)))
    lib = _lib(kind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "wgmma":
            o = q.new_empty((*q.shape[:-1], Dv))
            (B, Sq, Hq, _), _ = _bshd(q)
            (_, Skv, Hkv, _), _ = _bshd(k)
            strides = (ctypes.c_int64 * 12)(*(
                s for t in (q, k, v, o) for s in _strides(t)))
            err = lib.flash_attention_fwd_sm90_strided(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                Sq, Skv, Hq, Hkv, D, Dv, strides, int(bool(causal)),
                int(window), int(q_offset), scale, stream)
        else:
            BH, Sq, _ = q.shape
            o = torch.empty_like(q)
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                _DTYPES[q.dtype], BH, Sq, k.shape[1], D, group,
                int(bool(causal)), int(window), int(q_offset), scale,
                stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({kind}) launch failed: error "
                           f"{err}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[kind] += 1
    return o
