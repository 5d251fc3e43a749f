"""The Hopper flash-attention kernels: ctypes binding and launch.

Two kernels replace the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py::flash_attention_bh``, chosen by ``variant(dtype, D)``:

  ``wgmma``   bf16 with D in (64, 128, 256):
              ``csrc/flash_attention_sm90.cu``, both products on the tensor
              cores (wgmma), Q, K and V staged by TMA — the LM prefills'
              path (qwen2-1.5B at D 128, the gemma models at D 256);
  ``scalar``  float32 at every D, and bf16 at D 16:
              ``csrc/flash_attention.cu``, scalar float32 FMAs.

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

# Kernel launches made by ``flash_attention_bh_cuda`` in this process (one
# per call), in all and by variant. Plain counters, so a run can show that
# its main path went through the kernels, and which.
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"wgmma": 0, "scalar": 0}

HEAD_DIMS = (16, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# TMA reads from 16-byte aligned global addresses only.
TMA_ALIGN = 16

_LIBS = {}


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that takes a call: ``"wgmma"`` for bf16 with D in
    ``WGMMA_HEAD_DIMS``, else ``"scalar"``."""
    return ("wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS
            else "scalar")


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "scalar":
            lib = _build.library("flash_attention")
            fn = lib.flash_attention_fwd
            fn.argtypes = [ptr] * 4 + [i32] * 8 + [ctypes.c_float, ptr]
        else:
            lib = _build.library("flash_attention_sm90")
            fn = lib.flash_attention_fwd_sm90
            fn.argtypes = [ptr] * 4 + [i32] * 7 + [ctypes.c_float, ptr]
        fn.restype = i32
        _LIBS[name] = lib
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 group: int = 1, window: int = 0) -> str:
    """Raise on what neither kernel takes; return the variant that takes
    the rest. Device-free, so that the CPU tests reach every refusal."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [BH, S, D], got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share one dtype and device")
    BH, Sq, D = q.shape
    BHkv, Skv = k.shape[0], k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if tuple(v.shape) != tuple(k.shape) or k.shape[2] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be [BHkv, Skv, {D}]")
    if group < 1 or BH != BHkv * group:
        raise ValueError(f"BHq {BH} != BHkv {BHkv} * group {group}")
    if min(BH, Sq, Skv) < 1 or BH > 65535 or max(q.numel(),
                                                 k.numel()) >= 2 ** 31:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    kind = variant(q.dtype, D)
    if kind == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % TMA_ALIGN:
                raise ValueError(f"{name} must be {TMA_ALIGN}-byte aligned "
                                 f"for the TMA loads of the wgmma kernel")
    return kind


def _refuse_grad(q, k, v) -> None:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_bh_cuda is forward-only: an input requires "
            "grad, and its output would carry no gradient. Training "
            "through the attention kernels is ROADMAP queue 1 item [3]; "
            "call it under torch.no_grad() or with detached inputs")


def flash_attention_bh_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, scale=None,
                            group: int = 1) -> torch.Tensor:
    """q: [BHq, Sq, D]; k, v: [BHkv, Skv, D] with BHq = BHkv * group, on
    the card. Returns [BHq, Sq, D] in q's dtype. Head ``h`` attends kv head
    ``h // group``; ``scale`` defaults to 1/sqrt(D) (the scalar kernel
    applies it to q in float32, the wgmma kernel to the float32 scores).
    Forward only: raises when grad is enabled and an input requires it."""
    _refuse_grad(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    kind = check_inputs(q, k, v, group=group, window=window)
    return _launch(kind, q, k, v, causal=causal, window=window, scale=scale,
                   group=group)


def _launch(kind: str, q, k, v, *, causal: bool, window: int, scale,
            group: int) -> torch.Tensor:
    """One call of the ``kind`` kernel on CUDA inputs that ``check_inputs``
    passed. The scalar kernel takes every such call, so timing code may
    hand it a call the wgmma kernel would take."""
    global LAUNCHES
    _refuse_grad(q, k, v)
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    scale = float(np.float32(scale if scale is not None
                             else 1.0 / np.sqrt(D)))
    lib = _lib(kind)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        if kind == "wgmma":
            err = lib.flash_attention_fwd_sm90(
                *ptrs, BH, Sq, Skv, D, group, int(bool(causal)), int(window),
                scale, stream)
        else:
            err = lib.flash_attention_fwd(
                *ptrs, _DTYPES[q.dtype], BH, Sq, Skv, D, group,
                int(bool(causal)), int(window), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({kind}) launch failed: error "
                           f"{err}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[kind] += 1
    return o
