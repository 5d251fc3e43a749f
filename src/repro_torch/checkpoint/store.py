"""Checkpointing with atomic commit — the on-disk format of
``repro/checkpoint/store.py``: one ``step-N/state.npz`` (tree paths joined
by ``/`` -> arrays) plus a JSON ``manifest.json``. A checkpoint the
reference saved loads here, and the other way round.

Trees are nested dicts whose leaves are tensors or numpy arrays; keys are
flattened in sorted order, as ``jax.tree_util`` flattens a dict. The
reference's resharding restore and async checkpointer are not ported.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}")
    final = os.path.join(directory, f"step-{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    np.savez(os.path.join(tmp, "state.npz"), **flat)
    manifest = dict(step=step, leaves=len(flat),
                    bytes=int(sum(v.nbytes for v in flat.values())),
                    **(extra or {}))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(directory)
             if d.startswith("step-")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target_tree) -> Any:
    """Restore into ``target_tree``'s structure: each leaf comes back as a
    numpy array of the target leaf's shape and dtype."""
    path = os.path.join(directory, f"step-{step}", "state.npz")
    data = np.load(path)

    def load(key, leaf):
        arr = data[key]
        want = _to_numpy(leaf)
        assert arr.shape == want.shape, (key, arr.shape, want.shape)
        return arr.astype(want.dtype)

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(tree[k], f"{prefix}{k}/") for k in tree}
        return load(prefix[:-1], tree)
    return walk(target_tree)
