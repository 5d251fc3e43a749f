"""Step builders of the LM path — the counterpart of
``repro/runtime/train_loop.py``: ``make_prefill_step`` and
``make_decode_step``. The training step waits for the LM training path
(ROADMAP queue 1 item 3)."""
from __future__ import annotations

import torch


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens, pos):
        logits, cache = model.decode(params, cache, tokens, pos)
        next_tok = torch.argmax(logits, dim=-1)[:, None]
        return next_tok, logits, cache
    return decode_step
