"""Deterministic synthetic token pipeline — the counterpart of
``repro/data/pipeline.py``.

Step-indexed: batch ``i`` is a pure function of (seed, i), so a restarted
or migrated job resumes mid-stream with no pipeline state to checkpoint —
the property WaterWise's checkpoint migration relies on. Tokens follow the
reference's Zipfian unigram (``_unigram_logits``, copied exactly), so the
loss curve is not that of uniform noise.

The draw is the port's own: ``jax.random``'s threefry stream has no torch
counterpart, so step ``i``'s tokens come from a CPU ``torch.Generator``
seeded from (seed, i) by inverse-CDF sampling of the unigram, and differ
from the reference's tokens (their distribution is the same). Drawn on the
host, they are the same on every device, and are then copied to
``device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.runtime import platform


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    device: Optional[str] = None

    def _unigram_logits(self) -> np.ndarray:
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** self.zipf_a
        return np.log(p / p.sum())

    @functools.cached_property
    def _cdf(self) -> torch.Tensor:
        return torch.from_numpy(np.cumsum(np.exp(self._unigram_logits())))

    def _generator(self, step: int) -> torch.Generator:
        """The CPU generator of step ``step``, seeded from (seed, step)."""
        seed = np.random.SeedSequence([self.seed, step]).generate_state(
            1, np.uint64)[0]
        return torch.Generator().manual_seed(int(seed))

    def batch(self, step: int, extras: Optional[Dict] = None) -> Dict:
        """{tokens, labels}: [global_batch, seq_len] int32 on the device,
        as the reference draws them, labels the tokens shifted by one (both
        cut from one draw of seq_len + 1), updated with ``extras``."""
        u = torch.rand((self.global_batch, self.seq_len + 1),
                       generator=self._generator(step), dtype=torch.float64)
        toks = torch.searchsorted(self._cdf, u, right=True).clamp_(
            max=self.vocab - 1).to(torch.int32)
        dev = platform.device(self.device)
        out = dict(tokens=toks[:, :-1].to(dev), labels=toks[:, 1:].to(dev))
        if extras:
            out.update(extras)
        return out


def make_batch_iterator(vocab: int, seq_len: int, global_batch: int,
                        seed: int = 0, start_step: int = 0,
                        extras: Optional[Dict] = None,
                        device: Optional[str] = None) -> Iterator[Dict]:
    src = SyntheticTokens(vocab, seq_len, global_batch, seed, device=device)
    step = start_step
    while True:
        yield src.batch(step, extras)
        step += 1
