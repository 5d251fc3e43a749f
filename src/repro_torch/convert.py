"""Carry the JAX package's state into the port.

For this system data plays the role of weights: telemetry and job traces,
and the learned forecaster's parameters.
These functions read the reference's objects field by field, by the names
of the port's dataclasses, so they need no import of the reference package
(any object with those attributes converts).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import problem, telemetry


def telemetry_from_reference(tele) -> telemetry.Telemetry:
    """A port ``Telemetry`` holding copies of ``tele``'s arrays."""
    fields = {}
    for f in dataclasses.fields(telemetry.Telemetry):
        value = getattr(tele, f.name)
        fields[f.name] = None if value is None else np.array(value)
    return telemetry.Telemetry(**fields)


def jobs_from_reference(jobs: Sequence) -> List[problem.Job]:
    """Port ``Job``s with every field of the reference jobs."""
    names = [f.name for f in dataclasses.fields(problem.Job)]
    out = []
    for job in jobs:
        kw = {name: getattr(job, name) for name in names}
        kw["deps"] = tuple(kw["deps"])
        out.append(problem.Job(**kw))
    return out


def learned_params_from_reference(tree, device="cpu") -> dict:
    """The reference learned forecaster's parameter tree (nested dicts of
    arrays, e.g. from ``repro.forecast.learned.init_params`` or a trained
    forecaster's ``_params``) as the port's: float32 tensors on ``device``
    under the same names. The port keeps the reference's layouts (a dense
    weight is ``[in, out]``, applied as ``x @ W``), so nothing is
    transposed."""
    if isinstance(tree, dict):
        return {k: learned_params_from_reference(v, device)
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)
