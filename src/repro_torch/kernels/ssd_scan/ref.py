"""Plain PyTorch versions of the SSD scan: the counterpart of
``repro/kernels/ssd_scan/ref.py``. ``ssd_ref`` is the model's chunked form
(``models/ssm.py::ssd_chunked``), ``ssd_naive`` the sequential recurrence;
the CUDA kernels are held against both. ``ssd_final_ref`` is the final
state from zero alone (``models/ssm.py::ssd_final_state``), the plain
version of the kernels' ``ssd_final_cuda`` entry. ``ssd_chunk_parallel`` is the
plain twin of the chunk-parallel design of ``csrc/ssd_scan_sm90.cu``,
stage by stage, and with ``rounding="kernel"`` it rounds the three
operands that kernel feeds as bf16 hi + lo pairs as the kernel does, so
the error those pairs leave is known on the CPU."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.ssm import ssd_chunked as ssd_ref  # noqa: F401
from repro_torch.models.ssm import \
    ssd_final_state as ssd_final_ref  # noqa: F401


def ssd_naive(x, dt, A, Bm, Cm):
    """O(S·N·P) sequential recurrence — ground truth for small shapes."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bf = Bm.to(torch.float32).repeat_interleave(rep, dim=2)
    Cf = Cm.to(torch.float32).repeat_interleave(rep, dim=2)
    a = torch.exp(dt.to(torch.float32) * A.to(torch.float32))    # [b,S,H]
    xdt = x.to(torch.float32) * dt.to(torch.float32)[..., None]
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state = (state * a[:, t, :, None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bf[:, t], xdt[:, t]))
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _hi_lo(t):
    """A float32 tensor as the sum of two bf16 values, as the kernel feeds
    it to the tensor cores (two products on the same other operand): hi its
    bf16 truncation (the top 16 bits), lo the rest rounded to bf16."""
    hi = (t.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi + _bf16(t - hi)


def ssd_chunk_parallel(x, dt, A, Bm, Cm, chunk: int = 256, rounding=None):
    """The chunk-parallel SSD of arXiv:2405.21060 §6 in the kernel's three
    stages. With a = dt·A and acs its cumulative sum within a chunk:

      1. per chunk c, S_c = sum_s x_s ⊗ B_s · exp(acs_last − acs_s) dt_s;
      2. h_in[0] = 0, h_in[c+1] = exp(acs_last_c) h_in[c] + S_c; the final
         state is h_in[nc];
      3. y_l = exp(acs_l) C_l · h_in[c]ᵀ
               + sum_{s ≤ l} (C_l · B_s) exp(acs_l − acs_s) dt_s x_s,
         with C · Bᵀ formed once per group.

    ``rounding=None`` keeps every operand in float32. ``"kernel"`` rounds
    the operands ``csrc/ssd_scan_sm90.cu`` pairs as it does: stage 1's
    x·exp(·)·dt, the h_in of stage 3's C·h_inᵀ and stage 3's weights P
    each as a bf16 hi + lo pair (two products on the same other operand);
    x, B and C enter as the values they are. It does not copy the kernel's
    factored decay (exp(acs_l − acs_s) as a row factor times a column
    factor where acs falls), so it approximates the kernel's float32
    rounding there. Rows past S are the exact dt = 0 padding of
    ``ssd_ref``. Returns (y [b,S,H,P], final state [b,H,P,N]) in x's
    dtype."""
    if rounding not in (None, "kernel"):
        raise ValueError(f"rounding must be None or 'kernel', got "
                         f"{rounding!r}")
    pair = _hi_lo if rounding else (lambda t: t)
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    pad = (-S) % L
    nc = (S + pad) // L
    rep = H // G

    def chunks(t):
        t = F.pad(t.to(torch.float32), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, L, *t.shape[2:])
    xc = chunks(x)                                           # [b,c,L,H,P]
    dtc = chunks(dt)                                         # [b,c,L,H]
    Bc = chunks(Bm)                                          # [b,c,L,G,N]
    Cc = chunks(Cm)
    acs = torch.cumsum(dtc * A.to(torch.float32), dim=2)     # [b,c,L,H]
    last = acs[:, :, -1]                                     # [b,c,H]
    Bh = Bc.repeat_interleave(rep, dim=3)                    # [b,c,L,H,N]
    Ch = Cc.repeat_interleave(rep, dim=3)

    # 1. Each chunk's own state contribution.
    w = torch.exp(last[:, :, None] - acs) * dtc              # [b,c,L,H]
    Sc = torch.einsum("bclhp,bclhn->bchpn", pair(xc * w[..., None]), Bh)

    # 2. The state entering each chunk, in order.
    h_in = [torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)]
    for c in range(nc):
        h_in.append(torch.exp(last[:, c])[..., None, None] * h_in[c]
                    + Sc[:, c])
    final = h_in[nc]
    hin = torch.stack(h_in[:nc], dim=1)                      # [b,c,H,P,N]

    # 3. Each chunk's output: the carried state, then the causal intra part.
    y = torch.einsum("bclhn,bchpn->bclhp", Ch, pair(hin))
    y = y * torch.exp(acs)[..., None]
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)          # per group
    CB = CB.repeat_interleave(rep, dim=2)                    # [b,c,H,L,L]
    seg = acs.transpose(2, 3)[..., :, None] - acs.transpose(2, 3)[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # Select before the exp: for s > l the exponent is positive.
    decay = torch.exp(torch.where(causal, seg, -torch.inf))  # [b,c,H,L,L]
    Pw = CB * decay * dtc.transpose(2, 3)[..., None, :]
    y = y + torch.einsum("bchls,bcshp->bclhp", pair(Pw), xc)
    y = y.reshape(b, nc * L, H, P)[:, :S]
    return y.to(x.dtype), final.to(x.dtype)
