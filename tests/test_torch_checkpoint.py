"""The port's checkpoint store against the JAX package's, in one process:
list and tuple trees flatten to the reference's keys, bf16 leaves are
stored as the reference's raw ``|V2`` patterns, and files cross between
the packages. Trees are drawn from numpy seeds; everything runs on the
CPU. The reference saves bf16 but cannot restore it (its ``astype`` of a
``|V2`` array raises), so bf16 crosses one way: reference to port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro_torch.checkpoint import (AsyncCheckpointer, checkpoint_bytes,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.runtime import elastic

LIST_KEYS = ["emb", "layers/0/w", "layers/1/w"]


def _list_tree(seed=0):
    """The float32 list tree: two [4, 4] layers and a [2] embedding."""
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.standard_normal((4, 4)).astype(np.float32)}
                       for _ in range(2)],
            "emb": rng.standard_normal(2).astype(np.float32)}


def _lm_f32(seed=0, layers=2, d=8, vocab=16):
    """An LM-shaped float32 tree: embedding, a ``layers`` list of blocks
    (one a tuple of norms), a final norm."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": f(vocab, d),
            "layers": [{"attn": {"wq": f(d, d), "wo": f(d, d)},
                        "norms": (f(d), f(d))} for _ in range(layers)],
            "final_norm": f(d)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 torch tensor or ml_dtypes array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("tree, want", [
    ({"w": np.zeros((4, 4), np.float32)}, 64),
    ("bf16", 32),
    ("list", 136),
    ("lm_bf16", 2 * (16 * 8 + 2 * (2 * 64 + 2 * 8) + 8)),
])
def test_checkpoint_bytes_matches_reference(tree, want):
    """bf16 counts 2 bytes an element, lists and tuples are walked into;
    the reference counts the same on the same tree."""
    if tree == "bf16":
        port, ref = ({"w": torch.zeros(4, 4, dtype=torch.bfloat16)},
                     {"w": jnp.zeros((4, 4), jnp.bfloat16)})
    elif tree == "list":
        port = ref = _list_tree()
    elif tree == "lm_bf16":
        port = _map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                    _lm_f32())
        ref = _map(lambda a: jnp.asarray(a, jnp.bfloat16), _lm_f32())
    else:
        port = ref = tree
    assert checkpoint_bytes(port) == want == ref_store.checkpoint_bytes(ref)


@pytest.mark.parametrize("direction", ["port_saves", "reference_saves"])
def test_float32_list_tree_crosses(tmp_path, direction):
    """A float32 tree with lists saved by one package restores in the
    other: keys ``layers/0/w``, ``layers/1/w``, ``emb``, leaves equal,
    lists rebuilt as lists."""
    tree = _list_tree(seed=3)
    save = (save_checkpoint if direction == "port_saves"
            else ref_store.save_checkpoint)
    restore = (ref_store.restore_checkpoint if direction == "port_saves"
               else restore_checkpoint)
    save(str(tmp_path), 4, tree)
    assert sorted(np.load(tmp_path / "step-4" / "state.npz")) == LIST_KEYS
    target = _map(np.zeros_like, tree)
    back = restore(str(tmp_path), 4, target)
    assert isinstance(back["layers"], list) and len(back["layers"]) == 2
    for got, want in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_bf16_tree_from_reference_restores_bit_exact(tmp_path):
    """A bf16 tree with lists and tuples: the reference saves, the port
    restores bf16 tensors with the reference's bit patterns, and the port's
    own ``state.npz`` of the same tree holds the reference's keys, dtypes
    (``|V2``) and bytes."""
    f32 = _lm_f32(seed=7)
    ref_tree = _map(lambda a: jnp.asarray(a, jnp.bfloat16), f32)
    port_tree = _map(lambda a: torch.from_numpy(a).to(torch.bfloat16), f32)
    ref_store.save_checkpoint(str(tmp_path / "ref"), 1, ref_tree)
    save_checkpoint(str(tmp_path / "port"), 1, port_tree)

    target = _map(torch.zeros_like, port_tree)
    back = restore_checkpoint(str(tmp_path / "ref"), 1, target)
    assert isinstance(back["layers"], list)
    assert isinstance(back["layers"][0]["norms"], tuple)
    for got, want in zip(_leaves(back), _leaves(ref_tree)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))

    ref_npz = np.load(tmp_path / "ref" / "step-1" / "state.npz")
    port_npz = np.load(tmp_path / "port" / "step-1" / "state.npz")
    assert sorted(port_npz) == sorted(ref_npz)
    assert "layers/1/norms/0" in port_npz
    for k in ref_npz:
        assert port_npz[k].dtype == ref_npz[k].dtype == np.dtype("|V2"), k
        assert port_npz[k].tobytes() == ref_npz[k].tobytes(), k


@pytest.mark.parametrize("saved, target", [
    (np.zeros(3, np.float64), np.zeros(3, np.float32)),
    (np.zeros(3, np.float32), torch.zeros(3, dtype=torch.bfloat16)),
    (torch.zeros(3, dtype=torch.bfloat16), torch.zeros(3)),
])
def test_restore_refuses_inexact_dtype(tmp_path, saved, target):
    """A saved dtype that does not cast exactly to the target leaf's
    raises, naming the key; a widening cast goes through."""
    save_checkpoint(str(tmp_path), 0, {"layers": [{"w": saved}]})
    with pytest.raises(TypeError, match="layers/0/w"):
        restore_checkpoint(str(tmp_path), 0, {"layers": [{"w": target}]})
    save_checkpoint(str(tmp_path), 1, {"w": np.ones(3, np.float32)})
    back = restore_checkpoint(str(tmp_path), 1, {"w": np.zeros(3)})
    assert back["w"].dtype == np.float64 and back["w"].sum() == 3.0


def _lm_bf16_state(seed):
    return _map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                _lm_f32(seed=seed))


def test_async_checkpointer_round_trips_bf16_lists(tmp_path):
    """``maybe_save`` snapshots a bf16 LM-shaped tree (the caller updates
    it in place at once) and the commit restores bit-exact."""
    st_ = _lm_bf16_state(seed=1)
    want = _map(torch.clone, st_)
    ck = AsyncCheckpointer(str(tmp_path), every=2)
    assert ck.maybe_save(2, st_)
    for leaf in _leaves(st_):
        leaf += 1.0                          # the snapshot was taken already
    ck.wait()
    assert latest_step(str(tmp_path)) == 2
    back = restore_checkpoint(str(tmp_path), 2, _lm_bf16_state(seed=9))
    for got, w in zip(_leaves(back), _leaves(want)):
        assert torch.equal(got, w)


def test_elastic_restart_recovers_bf16_lists(tmp_path):
    """``run_elastic`` on a bf16 LM-shaped tree with injected failures ends
    in exactly the uninterrupted run's state, lists and tuples rebuilt and
    every leaf a bf16 tensor."""
    def step_fn(state, batch, step):
        return _map(lambda x: x + batch, state)

    def batch_fn(step):
        return torch.tensor(0.125 * (step + 1), dtype=torch.bfloat16)

    clean = elastic.run_elastic(_lm_bf16_state(2), step_fn, batch_fn,
                                num_steps=8, ckpt_dir=str(tmp_path / "a"),
                                ckpt_every=3)
    faulty = elastic.run_elastic(
        _lm_bf16_state(2), step_fn, batch_fn, num_steps=8,
        ckpt_dir=str(tmp_path / "b"), ckpt_every=3,
        injector=elastic.FailureInjector(fail_after_steps=(4, 7)))
    assert faulty["restarts"] == 2 and faulty["steps_run"] == 8 + 2
    assert isinstance(faulty["state"]["layers"], list)
    assert isinstance(faulty["state"]["layers"][1]["norms"], tuple)
    for a, b in zip(_leaves(clean["state"]), _leaves(faulty["state"])):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_adamw_state_crosses(tmp_path, direction):
    """A (params, AdamW state) tree, the state a named tuple whose step is
    a Python int in the port and an int32 scalar in the reference: the
    port writes a field under the reference's ``.name`` key, the files
    cross both ways, and ``run_elastic``'s restore gives the port's state
    back with its named tuple and its int step."""
    from repro.optim.adamw import AdamWState as RefState
    from repro_torch.optim.adamw import AdamWState
    tree = _list_tree(3)
    port = (_map(torch.from_numpy, tree),
            AdamWState(step=7, mu=_map(torch.from_numpy, _list_tree(4)),
                       nu=_map(torch.from_numpy, _list_tree(5))))
    ref = (_map(jnp.asarray, tree),
           RefState(step=jnp.asarray(7, jnp.int32),
                    mu=_map(jnp.asarray, _list_tree(4)),
                    nu=_map(jnp.asarray, _list_tree(5))))
    d = str(tmp_path)
    if direction == "port_to_ref":
        save_checkpoint(d, 1, port)
        keys = sorted(np.load(f"{d}/step-1/state.npz").files)
        ref_store.save_checkpoint(str(tmp_path / "r"), 1, ref)
        assert keys == sorted(np.load(f"{tmp_path}/r/step-1/state.npz").files)
        assert "1/.step" in keys and "1/.mu/layers/0/w" in keys
        back = ref_store.restore_checkpoint(d, 1, ref)
        assert int(back[1].step) == 7
    else:
        ref_store.save_checkpoint(d, 1, ref)
    back = elastic._like(restore_checkpoint(d, 1, port), port)
    assert isinstance(back[1], AdamWState)
    assert isinstance(back[1].step, int) and back[1].step == 7
    for a, b in zip(_leaves(back), _leaves(port)):
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
