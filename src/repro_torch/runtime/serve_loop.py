"""Serving loop: batched prefill, then greedy decode — the counterpart of
``repro/runtime/serve_loop.py``. Runs eagerly under
``torch.inference_mode()`` (no jit counterpart is needed), on the card
unless the caller asks for another device."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.runtime import platform
from repro_torch.runtime.train_loop import make_decode_step, make_prefill_step


class Server:
    """Minimal batched server: prefill a batch of prompts, then decode
    greedily to ``max_new`` tokens. Caches hold prompt_len + max_new
    positions. ``params`` must lie on ``device`` (``None``: the card)."""

    def __init__(self, model, params, device=None):
        self.device = platform.device(device)
        where = params["embed"]["tokens"].device
        if where.type != self.device.type:
            raise ValueError(f"params lie on {where}, the server runs on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.prefill_step = make_prefill_step(model)
        self.decode_step = make_decode_step(model)

    def generate(self, batch: Dict, max_new: int = 16) -> np.ndarray:
        """batch["tokens"]: [B, S] integer prompts (numpy or a tensor);
        ``frames`` [B, S_src, d] (encdec) or ``patches`` [B, n_img, d]
        (vision), numpy or tensors, go to the prefill, and the cross
        caches take the lengths ``Model.cache_lengths`` gives. Tokens are
        int32, as the reference's. Returns the [B, max_new] greedy tokens
        as int32. Spans ``serve.prefill`` (to
        the first token, synchronized) and ``serve.decode`` (the other
        max_new - 1 steps, to the tokens on the host) time the two phases
        when ``repro_torch.obs`` is on."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int32).to(self.device)
        B, S = tokens.shape
        inputs = dict(tokens=tokens)
        for key in ("frames", "patches"):
            if batch.get(key) is not None:
                inputs[key] = torch.as_tensor(batch[key]).to(self.device)
        lengths = self.model.cache_lengths(inputs)
        with torch.inference_mode():
            with obs.span("serve.prefill", batch=B, prompt=S):
                cache = self.model.init_cache(B, S + max_new, self.device,
                                              **lengths)
                last_logits, built = self.prefill_step(self.params, inputs)
                cache = _splice(cache, built)
                tok = torch.argmax(last_logits, dim=-1).to(
                    torch.int32)[:, None]
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            out = [tok]
            with obs.span("serve.decode", batch=B, steps=max_new - 1):
                for i in range(max_new - 1):
                    tok, _, cache = self.decode_step(self.params, cache, tok,
                                                     S + i)
                    out.append(tok)
                result = torch.cat(out, dim=1).cpu().numpy()
        return result


def _splice(cache, built):
    """Copy prefill-built KV/state into the zero-padded decode cache, in
    place. Leaves whose shapes already match (recurrent states, conv
    tails) are copied whole; a KV leaf fills the cache's leading positions
    along the sequence axis."""
    if isinstance(cache, dict):
        return {k: _splice(cache[k], built[k]) for k in cache}
    if isinstance(cache, (list, tuple)):
        return type(cache)(_splice(c, b) for c, b in zip(cache, built))
    if cache is None:
        return None
    if cache.shape == built.shape:
        return cache.copy_(built)
    ax = next(i for i, (c, b) in enumerate(zip(cache.shape, built.shape))
              if c != b)
    cache.narrow(ax, 0, built.shape[ax]).copy_(built)
    return cache
