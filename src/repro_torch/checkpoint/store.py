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
blocks on disk) with at most one commit in flight.

A sharded tree (DTensor leaves, ``runtime/sharding.py``) is saved in the
same format: every rank gathers each leaf's full array (a collective, so
every rank calls ``save_checkpoint``), rank 0 alone writes, and the ranks
meet at a barrier after the commit. ``restore_checkpoint(...,
shardings=...)`` re-shards each leaf onto a target mesh, which may differ
from the mesh that saved: every rank reads the file and keeps its own
block.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.runtime import sharding


def _to_numpy(leaf) -> np.ndarray:
    if sharding.is_dtensor(leaf):
        leaf = sharding.gather_tree(leaf)
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:         # numpy has no bfloat16
            return leaf.contiguous().view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _map_leaves(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, walked in
    ``jax.tree_util``'s order (dict keys sorted, sequences in index
    order, a named tuple's fields in their order, each path part
    ``.name`` as the reference writes a ``GetAttrKey``); dicts, lists,
    tuples and named tuples keep their kind."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, getattr(tree, f),
                                        f"{prefix}.{f}/")
                            for f in tree._fields))
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


def _collective(tree) -> bool:
    """Whether ``tree`` holds DTensor leaves (every rank saves it)."""
    return any(sharding.is_dtensor(x) for x in _flatten(tree).values())


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    """Write ``tree`` as ``directory/step-N`` (atomic rename). A tree with
    DTensor leaves is gathered on every rank and written by rank 0."""
    if _collective(tree):
        host = _map_leaves(lambda _, x: _to_numpy(x), tree)
        final = os.path.join(directory, f"step-{step}")
        if _rank() == 0:
            _write(directory, step, host, extra)
        _barrier()
        return final
    return _write(directory, step, tree, extra)


def _write(directory: str, step: int, tree, extra) -> str:
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


def restore_checkpoint(directory: str, step: int, target_tree,
                       shardings=None, mesh=None) -> Any:
    """Restore into ``target_tree``'s structure: each leaf comes back as a
    numpy array of the target leaf's shape and dtype, except that a bf16
    target leaf comes back as a bf16 CPU tensor, bit for bit the saved
    ``|V2`` patterns. A saved dtype that does not cast exactly (numpy's
    ``safe`` rule) to the target's raises, naming the key.

    ``shardings`` (the target tree's structure) re-shards every leaf: a
    leaf of ``(mesh, placements)``, or a spec (``runtime/sharding.py``)
    with ``mesh`` given, places it as a DTensor on that mesh, on the
    mesh's device type; ``None`` at a leaf leaves it as above. A DTensor
    target leaf's shape is its global shape."""
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

    restored = _map_leaves(load, target_tree)
    if shardings is None:
        return restored
    return _map_leaves(lambda key, arr: _place(arr, _at(shardings, key),
                                                mesh), restored)


def _at(tree, key: str):
    """The node of ``tree`` at a ``/``-joined path (list indices as
    decimal strings)."""
    for part in key.split("/") if key else ():
        if isinstance(tree, dict):
            tree = tree[part]
        elif part.startswith("."):
            tree = getattr(tree, part[1:])
        else:
            tree = tree[int(part)]
    return tree


def _place(arr, target, mesh):
    """``arr`` (restored) as a DTensor by ``target``: (mesh, placements),
    or a spec on ``mesh``; None leaves it."""
    if target is None:
        return arr
    if sharding.is_axes(target):
        if mesh is None:
            raise ValueError("restoring by specs needs the mesh")
        target_mesh, spec = mesh, target
    else:
        target_mesh, places = target
        spec = sharding.spec_of(places, target_mesh)
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    t = t.to(target_mesh.device_type)
    return sharding.shard_leaf(t, spec, target_mesh)


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
        self._collective = False
        self.saved_steps = []
        # One record a commit: step, bytes, the copy off the device inside
        # ``maybe_save`` (on the caller's path) and the background write,
        # in seconds.
        self.commits = []

    def maybe_save(self, step: int, tree, extra=None) -> bool:
        """A sharded tree is gathered here, on every rank (a collective);
        rank 0's thread writes it, and ``wait`` then holds every rank at
        a barrier until the commit is on disk."""
        if step % self.every:
            return False
        self.wait()                       # at most one in flight
        self._collective = _collective(tree)
        t0 = time.perf_counter()
        host_tree = _map_leaves(lambda _, x: np.array(_to_numpy(x)), tree)
        record = dict(step=step, copy_s=time.perf_counter() - t0,
                      bytes=sum(int(x.nbytes)
                                for x in _flatten(host_tree).values()))

        def work():
            t1 = time.perf_counter()
            if not self._collective or _rank() == 0:
                _write(self.directory, step, host_tree, extra)
            record["write_s"] = time.perf_counter() - t1
            self.commits.append(record)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._collective:
                _barrier()
