"""Tensor-parallel MLA, MoE, Mamba-2 and RG-LRU over ``model``, on four
gloo ranks on the CPU, against the port's unsharded steps and the
reference; and their pieces without ranks.

The four-rank case runs this file as a script (``python
tests/test_torch_tensor_parallel_layers.py layers DIR``), as
``test_torch_distributed.py`` runs its cases: four ranks meet by
``file://`` rendezvous in ``DIR``, import neither jax nor the JAX
package, and leave their results in ``DIR``; the reference's side runs in
the test process.

- Train on (1, 4) ("data", "model"), float64: reduced DeepSeek-V2 (MLA's
  4 heads over 4, 8 experts over 4, the shared expert and the dense
  layer's MLP column-parallel), reduced DBRX (4 experts over 4), DBRX
  with 6 experts (which 4 does not divide: each expert's d_ff over
  ``model``), reduced mamba2-2.7B (4 heads over 4; the packed ``in_proj``
  and conv in blocks of 73 and 40 columns that cut across heads) and
  reduced recurrentgemma-2B (64 channels over 4): the loss, the gradient
  norm, every leaf's gradient and the AdamW step's parameters against the
  unsharded step's.
- Serve on (1, 4) for the same five, on (2, 2) for DeepSeek-V2 and a
  two-group mamba2, and on (1, 4) for minicpm3 at 6 MLA heads (which 4
  does not divide: MLA computes whole): prefill and decode logits against
  the unsharded steps' and, gathered, against the reference's
  ``Server``, with its greedy tokens.
- The new collectives (``TensorParallel.whole``, ``scatter_sum``,
  ``sum``) on the (2, 2) mesh's two-rank ``model`` groups: forward and
  backward against autograd of the whole computation.
- Without ranks: the Mamba-2 mixer's column and group selection for
  several (H, G, m) against the unsharded split, and the local MoE
  dispatch against the unsharded one.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_distributed import (RUN_TIMEOUT_S, SEQ_ATOL, SERVE_B,
                                    SERVE_N, SERVE_S, SHARD_RTOL, WORLD,
                                    _init, _mesh, _rel, _serve_sharded,
                                    _serve_unsharded)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TP_MESH = (1, 4)
# Train cases on TP_MESH: (arch, config overrides).
TRAIN = {"deepseek_v2_236b": ("deepseek_v2_236b", {}),
         "dbrx_132b": ("dbrx_132b", {}),
         "dbrx_e6": ("dbrx_132b", dict(n_experts=6)),
         "mamba2_2_7b": ("mamba2_2_7b", {}),
         "recurrentgemma_2b": ("recurrentgemma_2b", {})}
# Serve cases: (arch, config overrides, mesh).
SERVE = dict(
    {f"{k}/1x4": (a, over, TP_MESH) for k, (a, over) in TRAIN.items()},
    **{"deepseek_v2_236b/2x2": ("deepseek_v2_236b", {}, (2, 2)),
       "mamba2_g2/2x2": ("mamba2_2_7b", dict(ssm_groups=2), (2, 2)),
       "minicpm3_h6/1x4": ("minicpm3_4b", dict(n_heads=6, n_kv=6),
                           TP_MESH)})
TRAIN_B, TRAIN_S = 4, 16
# Collective checks: float64, sums of two terms, exact but for the last
# bit of a product.
COLL_ATOL = 1e-12


# ---------------------------------------------------------------------------
# The ranks (no jax here)
# ---------------------------------------------------------------------------

def _collectives(mesh) -> dict:
    """Each new collective's forward and backward on this rank's
    two-rank ``model`` group against autograd of the whole: every rank
    takes the same seeded full tensors, its own block or partial of
    them, and its own downstream weights ``W[r]``; the whole loss is the
    sum of the ranks' losses."""
    from repro_torch.runtime import sharding
    i = list(mesh.mesh_dim_names).index("model")
    tp = sharding.TensorParallel(sharding.coordinates(mesh)["model"],
                                 mesh.size(i), mesh.get_group(i))
    m, r, n = tp.size, tp.rank, 4 * tp.size
    g = torch.Generator().manual_seed(7)
    f64 = torch.float64
    X = torch.randn(3, n, generator=g, dtype=f64)
    P = torch.randn(m, 3, n, generator=g, dtype=f64)
    W = torch.randn(m, 3, n, generator=g, dtype=f64)
    blk = tp.block(n)
    out = {}

    def whole_grad(fn, t):
        t = t.clone().requires_grad_(True)
        y = fn(t)
        (gt,) = torch.autograd.grad(y[1], t)
        return y[0].detach(), gt

    # whole: every rank uses X whole, its loss through W[r]
    x = X[:, blk].clone().requires_grad_(True)
    y = tp.whole(x, 1, n)
    (gx,) = torch.autograd.grad((y * W[r]).sum(), x)
    want_y, want_g = whole_grad(lambda t: (t, (t * W).sum()), X)
    out["whole"] = ((y - want_y).abs().max().item(),
                    (gx - want_g[:, blk]).abs().max().item())
    # scatter_sum: rank r's partial P[r], its block of the sum
    x = P[r].clone().requires_grad_(True)
    y = tp.scatter_sum(x, 1)
    (gx,) = torch.autograd.grad((y * W[r][:, blk]).sum(), x)
    want_y, want_g = whole_grad(lambda t: (t.sum(0), sum(
        (t.sum(0)[:, q * 4:(q + 1) * 4] * W[q][:, q * 4:(q + 1) * 4]).sum()
        for q in range(m))), P)
    out["scatter_sum"] = ((y - want_y[:, blk]).abs().max().item(),
                          (gx - want_g[r]).abs().max().item())
    # sum: every rank needs the sum, its loss through W[r]
    x = P[r][:, :1].clone().requires_grad_(True)
    y = tp.sum(x)
    (gx,) = torch.autograd.grad((y * W[r][:, :1]).sum(), x)
    want_y, want_g = whole_grad(lambda t: (t.sum(0), sum(
        (t.sum(0) * W[q][:, :1]).sum() for q in range(m))), P[:, :, :1])
    out["sum"] = ((y - want_y).abs().max().item(),
                  (gx - want_g[r]).abs().max().item())
    import torch.distributed as dist
    errs = torch.tensor([v for pair in out.values() for v in pair],
                        dtype=f64)
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    return {k: (errs[2 * j].item(), errs[2 * j + 1].item())
            for j, k in enumerate(out)}


def _train_case(model, params, batch, mesh) -> dict:
    """The float64 unsharded and sharded train steps' parts on ``params``
    and ``batch``: loss, gradient norm, each leaf's gradient (the
    sharded blocks gathered) and the updated parameters, compared in the
    rank; and the sharded update against the unsharded AdamW step on the
    sharded gradients, gathered."""
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import (shard_train_state,
                                                train_parts)
    from test_torch_train import STEP_LR
    opt = adamw(lr=lambda s: STEP_LR)
    whole = train_parts(model, opt)
    loss, grads = whole.grads(whole.live(params), batch)
    new, _, gnorm = whole.finish(params, opt.init(params), grads)
    sp, so = shard_train_state(model, params, opt, mesh)
    parts = train_parts(model, opt, None, mesh)
    sloss, sgrads = parts.grads(parts.live(sp), batch)
    leaves = tree_leaves(sp)
    full = [sharding.gather_tree(sharding._from_local(
        g.contiguous(), mesh, p.placements, p.shape))
        for g, p in zip(sgrads, leaves)]
    snew, _, sgnorm = parts.finish(sp, so, list(sgrads))
    snew = tree_leaves(sharding.gather_tree(snew))
    same, _, _ = whole.finish(params, opt.init(params),
                              [g.clone() for g in full])
    split = sum(p.placements[-1].is_shard() for p in leaves)
    return dict(
        loss=loss.item(), sharded_loss=sloss.item(),
        grad_norm=float(gnorm), sharded_grad_norm=float(sgnorm),
        grad_rel=[_rel(a.numpy(), b.numpy()) for a, b in zip(full, grads)],
        step_rel=[_rel(a.numpy(), b.numpy())
                  for a, b in zip(snew, tree_leaves(same))],
        old=[t.numpy() for t in tree_leaves(params)],
        new=[t.numpy() for t in snew],
        ref_new=[t.numpy() for t in tree_leaves(new)],
        split_over_model=split, leaves=len(leaves))


def _rank_layers(rank: int, run_dir: str):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_map
    _init(rank, run_dir)
    inputs = torch.load(os.path.join(run_dir, "inputs.pt"))
    out = dict(collectives=_collectives(_mesh((2, 2), ("data", "model"))),
               train={}, serve={})
    mesh = _mesh(TP_MESH, ("data", "model"))
    for name, (arch, over) in TRAIN.items():
        cfg = get_config(arch, reduced=True).replace(
            dtype="float64", param_dtype="float64", block_kv=8, **over)
        params = tree_map(lambda t: t.double(), inputs[name]["params"])
        out["train"][name] = _train_case(Model(cfg), params,
                                         inputs[name]["batch"], mesh)
    torch.set_grad_enabled(False)
    length = SERVE_S + SERVE_N + 1
    for name, (arch, over, shape) in SERVE.items():
        cfg = get_config(arch, reduced=True).replace(
            dtype="float32", param_dtype="float32", **over)
        model = Model(cfg)
        params, batch = inputs[name]["params"], inputs[name]["batch"]
        whole = _serve_unsharded(model, params, batch, length, SERVE_N)
        out["serve"][name] = _serve_sharded(
            model, params, batch, _mesh(shape, ("data", "model")), length,
            SERVE_N, whole)
    if rank == 0:
        np.save(os.path.join(run_dir, "layers.npy"), out, allow_pickle=True)


def _entry(rank, case, run_dir):
    dict(layers=_rank_layers)[case](rank, run_dir)
    import torch.distributed as dist
    dist.destroy_process_group()


def main(argv):
    import torch.multiprocessing as mp
    case, run_dir = argv
    mp.spawn(_entry, args=(case, run_dir), nprocs=WORLD, join=True)


# ---------------------------------------------------------------------------
# The tests (this process has jax)
# ---------------------------------------------------------------------------

def _spawn(case: str, run_dir) -> None:
    """Runs ``case`` on four ranks under RUN_TIMEOUT_S; the whole process
    group is killed if it overruns."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             case, str(run_dir)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"{case}: four gloo ranks did not finish in "
                    f"{RUN_TIMEOUT_S} s:\n{log.decode()[-4000:]}")
    assert proc.returncode == 0, log.decode()[-6000:]


@pytest.fixture(scope="module")
def layers_run(tmp_path_factory):
    """The ``layers`` case on four ranks, and the reference's side: each
    case's reduced pair (train_pair: live Mamba-2 and RG-LRU draws), a
    B 4 train batch and B 4 prompts."""
    from test_torch_lm_mla_moe import inputs as prompts
    from test_torch_train import train_batch, train_pair
    run_dir = tmp_path_factory.mktemp("layers")
    inputs, pairs = {}, {}
    for name, (arch, over) in TRAIN.items():
        _, _, m, pp = train_pair(arch, block_kv=8, **over)
        _, pb = train_batch(m.cfg, B=TRAIN_B, S=TRAIN_S)
        inputs[name] = dict(params=pp, batch=pb)
    for i, (name, (arch, over, _)) in enumerate(SERVE.items()):
        jm, jp, m, pp = train_pair(arch, **over)
        _, extra, jb, pb = prompts(m.cfg, B=SERVE_B, S=SERVE_S, seed=90 + i)
        inputs[name] = dict(params=pp, batch=pb)
        pairs[name] = (jm, jp, m.cfg, jb, extra)
    torch.save(inputs, os.path.join(run_dir, "inputs.pt"))
    _spawn("layers", run_dir)
    out = np.load(os.path.join(run_dir, "layers.npy"),
                  allow_pickle=True).item()
    return out, pairs


@pytest.mark.parametrize("case", list(TRAIN))
def test_tensor_parallel_train_matches_unsharded(layers_run, case):
    """In float64 on (1, 4): the sharded step's loss and gradient norm
    within SHARD_RTOL of the unsharded step's, every leaf's gradient (the
    rank's blocks gathered) within SHARD_RTOL of the leaf's largest
    entry; every updated parameter within SHARD_RTOL of the leaf's
    largest entry of the unsharded AdamW step on those gradients, and
    within test_torch_train's limits of the unsharded step's updates (a
    first step divides each gradient by its own magnitude, so an entry
    whose gradient is float32 rounding noise — the router, the RG-LRU
    gates and attention's blocked twin compute in float32 whatever the
    dtype, as the reference's do — steps by another fraction of lr: up
    to 1.8e-4 of a float64 leaf's largest entry when this was written;
    ROADMAP queue 3); most leaves split over ``model`` (the four
    sub-layers' included)."""
    from test_torch_train import assert_same_update
    out, _ = layers_run
    r = out["train"][case]
    assert r["split_over_model"] >= r["leaves"] // 2, r["split_over_model"]
    assert abs(r["sharded_loss"] - r["loss"]) <= SHARD_RTOL * r["loss"]
    assert abs(r["sharded_grad_norm"] - r["grad_norm"]) <= \
        SHARD_RTOL * r["grad_norm"]
    assert max(r["grad_rel"]) <= SHARD_RTOL, r["grad_rel"]
    assert max(r["step_rel"]) <= SHARD_RTOL, r["step_rel"]
    assert_same_update(r["old"], r["new"], r["ref_new"])


@pytest.mark.parametrize("case", list(SERVE))
def test_tensor_parallel_serving_matches_unsharded_and_reference(layers_run,
                                                                 case):
    """Prefill and every decode step's logits within SHARD_RTOL of the
    unsharded steps' largest entry (the padded vocabulary's -1e9
    included) and within SEQ_ATOL of each entry (float32 sums over
    ``model`` in another order: 1.4-5.7e-6 at logits of 3-5 when this was
    written), and the same greedy tokens; the gathered logits within
    test_torch_lm's float32 limits of the reference's ``Server`` run and
    its greedy tokens equal."""
    from test_torch_lm import F32_TOL
    from test_torch_lm_mla_moe import reference_run
    out, pairs = layers_run
    r = out["serve"][case]
    assert r["whole_rel"] <= SHARD_RTOL, r["whole_rel"]
    assert r["whole_max_abs"] <= SEQ_ATOL, r["whole_max_abs"]
    assert r["tokens_equal"]
    jm, jp, cfg, jb, extra = pairs[case]
    tokens, logits, _, steps, _ = reference_run(jm, jp, cfg, jb, extra,
                                                SERVE_N + 1)
    np.testing.assert_array_equal(r["tokens"], np.asarray(tokens))
    np.testing.assert_allclose(r["prefill"], np.asarray(logits), **F32_TOL)
    for port, ref in zip(r["decode"], steps):
        np.testing.assert_allclose(port, np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("name", ["whole", "scatter_sum", "sum"])
def test_new_collectives_match_autograd_of_the_whole(layers_run, name):
    """On a two-rank ``model`` group: ``whole`` (all-gather forward,
    reduce-scatter backward), ``scatter_sum`` (reduce-scatter forward,
    all-gather backward) and ``sum`` (all-reduce both ways) give the
    whole computation's values and, for each rank's block or partial,
    its gradient of the sum of every rank's loss."""
    out, _ = layers_run
    fwd, bwd = out["collectives"][name]
    assert fwd <= COLL_ATOL and bwd <= COLL_ATOL, (fwd, bwd)


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------

# (d_inner, head_dim, groups, state, model): mamba2-2.7B's on 16 and 8
# (one group), reduced (4 heads over 4 and 2), two groups, and groups
# that a rank's heads straddle (12 heads in 3 groups on 2 and 4).
MIXER_CASES = [(5120, 64, 1, 128, 16), (5120, 64, 1, 128, 8),
               (128, 32, 1, 16, 4), (128, 32, 1, 16, 2),
               (128, 32, 2, 16, 2), (128, 32, 2, 16, 4),
               (384, 32, 3, 8, 2), (384, 32, 3, 8, 4),
               (256, 32, 8, 4, 2)]


@pytest.mark.parametrize("d_inner,P,G,N,m", MIXER_CASES)
def test_mamba2_columns_are_the_unsharded_split_at_the_ranks_heads(
        d_inner, P, G, N, m):
    """On each rank, the ``in_proj`` and conv columns ``local_columns``
    cuts, in order, are the unsharded split's z, x and dt at the rank's
    heads and every group's B and C; ``local_groups`` gives each local
    head the group the unsharded SSD broadcasts to it."""
    from repro_torch.models import ssm
    H, gn = d_inner // P, G * N
    cols = torch.arange(2 * d_inner + 2 * gn + H)
    z, xbc, dt = torch.split(cols, [d_inner, d_inner + 2 * gn, H])
    xs, Bc, Cc = torch.split(xbc, [d_inner, gn, gn])
    conv = torch.arange(d_inner + 2 * gn)
    cx, cb, cc = torch.split(conv, [d_inner, gn, gn])
    hl, dl = H // m, d_inner // m
    group_of = torch.arange(H) // (H // G)
    for r in range(m):
        ranges, conv_ranges = ssm.local_columns(d_inner, gn, H, r, m)
        got = ssm._cut(cols, ranges)
        heads = slice(r * dl, (r + 1) * dl)
        want = torch.cat([z[heads], xs[heads], Bc, Cc,
                          dt[r * hl:(r + 1) * hl]])
        assert torch.equal(got, want), (r, got, want)
        assert torch.equal(ssm._cut(conv, conv_ranges),
                           torch.cat([cx[heads], cb, cc]))
        ids = torch.arange(G).view(1, 1, G, 1).expand(1, 1, G, N)
        sel = ssm.local_groups(ids, H, r * hl, hl)[0, 0, :, 0]
        assert hl % sel.numel() == 0
        per_head = sel.repeat_interleave(hl // sel.numel())
        assert torch.equal(per_head, group_of[r * hl:(r + 1) * hl]), r


@pytest.mark.parametrize("E,k,S,m", [(8, 2, 16, 4), (160, 6, 64, 8),
                                     (16, 4, 32, 16), (4, 2, 5, 2)])
def test_local_moe_dispatch_keeps_the_unsharded_assignments(E, k, S, m):
    """Over each rank's experts ``[r E/m, (r + 1) E/m)``, the local
    dispatch keeps exactly the unsharded dispatch's kept assignments to
    those experts, at the same slots, and drops the rest; over the ranks
    every kept assignment is kept once. Skewed routing makes drops."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(E + k)
    B = 3
    probs = torch.softmax(torch.randn(B, S, E, generator=g) * 3 + torch.arange(
        E, dtype=torch.float32) / E * 4, -1)
    _, ids = moe.route(torch.log(probs), torch.eye(E), k)
    C = moe.capacity(S, k, E, 1.25)
    order, keep, e_idx, s_idx = moe.dispatch(ids, k, E, C)
    assert (~keep).any()                          # some assignments drop
    held = E // m
    kept = torch.zeros_like(keep, dtype=torch.int64)
    for r in range(m):
        lo = r * held
        o, kp, e, s = moe.dispatch(ids, k, E, C, lo, lo + held)
        assert torch.equal(o, order)
        mine = keep & (e_idx >= lo) & (e_idx < lo + held)
        assert torch.equal(kp, mine), r
        assert torch.equal(e[kp] + lo, e_idx[kp]) and torch.equal(
            s[kp], s_idx[kp])
        kept += kp.long()
    assert torch.equal(kept, keep.long())


if __name__ == "__main__":
    main(sys.argv[1:])
