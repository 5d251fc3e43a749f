"""Carry the JAX package's state into the port.

For this system data plays the role of weights: telemetry and job traces,
the learned forecaster's parameters, and the LM path's model parameters
(and gradient trees, which have the parameters' structure), carried both
ways.
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
from repro_torch.models import transformer


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


def _lm_stacks(cfg) -> dict:
    """The stacks of an LM tree and their lengths along the reference's
    leading axis."""
    if cfg.family == "griffin":
        n_groups, rem = divmod(cfg.n_layers, 3)
        return dict(groups=n_groups, tail=rem)
    if cfg.family == "vision":
        return dict(groups=cfg.n_layers // cfg.cross_every)
    if cfg.family == "encdec":
        return dict(enc_layers=cfg.enc_layers, layers=cfg.n_layers)
    return dict(dense_layers=cfg.first_dense,
                layers=cfg.n_layers - cfg.first_dense)


def lm_params_from_reference(tree, cfg, device="cpu") -> dict:
    """The reference LM's parameter values (the ``params`` of
    ``repro.models.Model.init``'s ``split_tree``, a nested dict of arrays
    whose stacks are stacked on a leading axis: the decoder's
    ``dense_layers`` and ``layers``, griffin's ``groups`` and ``tail``,
    vision's ``groups`` with each group's ``selfs`` stacked again inside,
    encdec's ``enc_layers`` and ``layers``) as the port's tree: the same
    names and layouts (``[in, out]``, ``[d, heads, head_dim]``), each
    stack unstacked into a list of per-layer (per-group) dicts, each leaf
    in its own dtype on ``device``. A bfloat16 leaf (an ``ml_dtypes``
    array, which ``torch.from_numpy`` rejects) goes through float32, which
    holds it exactly."""
    transformer.check_supported(cfg)

    def leaf(value):
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return leaf(node)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return node[i].clone()

    def unstack(node, n):
        return [layer(node, i) for i in range(n)]

    stacks = _lm_stacks(cfg)
    out = {}
    for k, v in tree.items():
        node = convert(v)
        out[k] = unstack(node, stacks[k]) if k in stacks else node
    if cfg.family == "vision":
        for group in out["groups"]:
            group["selfs"] = unstack(group["selfs"], cfg.cross_every - 1)
    return out


def lm_params_to_reference(tree, cfg) -> dict:
    """The inverse of ``lm_params_from_reference``: the port's LM tree (of
    parameters, gradients or optimizer moments) as the reference's, each
    list of per-layer (per-group) dicts stacked on a leading axis (vision's
    ``selfs`` inside each group first), as float32 numpy arrays (a bf16
    leaf is exact in float32)."""
    transformer.check_supported(cfg)

    def leaf(t):
        return t.detach().to("cpu", torch.float32).numpy()

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return leaf(node)

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    stacks = _lm_stacks(cfg)
    out = {}
    for k, v in tree.items():
        if k not in stacks:
            out[k] = convert(v)
            continue
        layers = [convert(lp) for lp in v]
        if cfg.family == "vision":
            layers = [dict(g, selfs=stack(g["selfs"])) for g in layers]
        out[k] = stack(layers)
    return out
