"""Checkpointing with atomic commit — the on-disk format of
``repro/checkpoint/store.py``: one ``step-N/state.npz`` (tree paths joined
by ``/`` -> arrays) plus a JSON ``manifest.json``. A checkpoint the
reference saved loads here. One the port saved loads in the reference,
except where it holds a bf16 leaf: the reference's restore casts the saved
``|V2`` bytes with ``astype``, which numpy refuses.

Trees are nested dicts, lists and tuples whose leaves are tensors or numpy
arrays, flattened as ``jax.tree_util`` flattens them: dict keys in sorted
order, sequences in index order, a list index joining the path as its
decimal string (``layers/0/w``). A bf16 leaf is stored as its raw 2-byte
patterns, numpy dtype ``|V2``: the bytes the reference writes for an
``ml_dtypes`` bfloat16 array.
``AsyncCheckpointer`` commits in a background thread (training never
blocks on disk) with at most one commit in flight. The reference's
resharding restore (its ``shardings`` argument) waits for mesh and
sharding (ROADMAP queue 1 item [3]).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:         # numpy has no bfloat16
            return leaf.contiguous().view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _map_leaves(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, walked in
    ``jax.tree_util``'s order (dict keys sorted, sequences in index
    order); dicts, lists and tuples keep their kind."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _flatten(tree) -> Dict[str, Any]:
    flat = {}
    _map_leaves(lambda key, leaf: flat.update({key: leaf}), tree)
    return flat


def _spec(leaf):
    """(shape, numpy dtype as stored) of a leaf, without copying it off its
    device."""
    if isinstance(leaf, torch.Tensor):
        dtype = (np.dtype("V2") if leaf.dtype == torch.bfloat16
                 else torch.empty(0, dtype=leaf.dtype).numpy().dtype)
        return tuple(leaf.shape), dtype
    leaf = np.asarray(leaf)
    return leaf.shape, leaf.dtype


def checkpoint_bytes(tree) -> int:
    """Size of the movable state — feeds Job.package_bytes in the
    scheduler."""
    return sum(int(np.prod(shape)) * dtype.itemsize
               for shape, dtype in map(_spec, _flatten(tree).values()))


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
    numpy array of the target leaf's shape and dtype, except that a bf16
    target leaf comes back as a bf16 CPU tensor, bit for bit the saved
    ``|V2`` patterns. A saved dtype that does not cast exactly (numpy's
    ``safe`` rule) to the target's raises, naming the key."""
    path = os.path.join(directory, f"step-{step}", "state.npz")
    data = np.load(path)

    def load(key, leaf):
        arr = data[key]
        shape, want = _spec(leaf)
        if arr.shape != shape:
            raise ValueError(f"{key}: saved shape {arr.shape}, "
                             f"target {shape}")
        if arr.dtype != want and (arr.dtype.kind == "V" or want.kind == "V"
                                  or not np.can_cast(arr.dtype, want,
                                                     "safe")):
            raise TypeError(f"{key}: saved dtype {arr.dtype} does not cast "
                            f"exactly to the target's {leaf.dtype}")
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return arr.astype(want)

    return _map_leaves(load, target_tree)


class AsyncCheckpointer:
    """Commits every ``every``-th step's state in a background thread, at
    most one commit in flight. The state is copied off the device
    (``.detach().cpu().numpy()`` for each tensor, copied again where that
    is a view of a CPU tensor) before ``maybe_save`` returns, so the caller
    may update it in place at once."""

    def __init__(self, directory: str, every: int = 50):
        self.directory = directory
        self.every = every
        self._thread: Optional[threading.Thread] = None
        self.saved_steps = []

    def maybe_save(self, step: int, tree, extra=None) -> bool:
        if step % self.every:
            return False
        self.wait()                       # at most one in flight
        host_tree = _map_leaves(lambda _, x: np.array(_to_numpy(x)), tree)

        def work():
            save_checkpoint(self.directory, step, host_tree, extra)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
