"""Device resolution for the port (counterpart of the JAX package's
``runtime/platform.py`` probe).

Entry points run on the card unless the caller asks for another device:
``device()`` returns CUDA when a card is present and raises otherwise —
nothing falls back to the CPU quietly. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["device", "on_hopper"]

DeviceLike = Union[str, torch.device, None]


def device(requested: DeviceLike = None) -> torch.device:
    """``requested`` as a ``torch.device``; with ``None``, the CUDA card.

    Raises ``RuntimeError`` when no device was requested and no card is
    present, so a CPU run is always the caller's explicit choice."""
    if requested is not None:
        return torch.device(requested)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "port on the CPU")
    return torch.device("cuda")


def on_hopper() -> bool:
    """True when the current card is a Hopper part, compute capability
    (9, 0) — the ``sm_90a`` target of the kernels."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0))
