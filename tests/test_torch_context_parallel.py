"""Context parallelism: the sequence split into contiguous segments over
``data`` in the sharded train and prefill steps — where a batch does not
divide ``data`` the reference's rules put ``act_seq`` on it (and
``seqpar`` on ``data`` and ``model``) — on four gloo ranks on the CPU,
against the port's unsharded steps and the reference; the offset
attention, the layout and the dry run without ranks.

The four-rank case runs this file as a script (``python
tests/test_torch_context_parallel.py ranks DIR``), as
``test_torch_sequence_parallel.py`` runs its ranks: they meet by
``file://`` rendezvous in ``DIR``, import neither jax nor the JAX
package, and leave their results in ``DIR``. The dry-run cells run it as
``python tests/test_torch_context_parallel.py dryrun OUT``. Both start
before the reference's side runs in the test process, and run beside it.

- Train in float64 (segments of 8): batch 1 and batch 2 on
  (4, 1) under the baseline rules (the sequence in four segments) for
  reduced
  qwen2-72B, mamba2-2.7B (the conv halo, the SSD state), recurrentgemma-2B
  (the halo, the RG-LRU state, the sliding window), DeepSeek-V2 (MLA's
  gathered latents, MoE's capacity slots) and SeamlessM4T (the encoder's
  segmented frames, cross-attention to the gathered memory); batch 1 on
  (2, 2) under ``seqpar`` (the sequence over ``data`` and ``model``) and
  ``act2d`` (over ``data``, the embedding over ``model``). The loss, the
  gradient norm, every leaf's gradient and the AdamW step against the
  unsharded step's; the loss and gradients against the reference's
  ``jax.value_and_grad``.
- Mamba-2 with two or more SSD chunks in every segment (MULTI_CHUNK):
  train in float64 at S 64 and 80 on (4, 1) (two chunks of 8 a segment,
  and two and a ragged third) and S 32 on (2, 2) under the baseline rules
  and ``seqpar``, against the unsharded step and the reference; S 64 on
  (4, 1) and S 32 on (2, 2) under ``seqpar`` in float32 (F32_MULTI_CHUNK);
  a float64 prefill of 64 positions on (4, 1) and greedy decode against
  the unsharded steps and the reference ``Server``.
- Prefill (float32, batch 1 on (4, 1)): the last logits against the
  unsharded step's, then greedy decode on the segments' caches (gathered,
  spliced and placed again) against the unsharded steps and the reference
  ``Server``.
- Without ranks: the plain attention at a query offset against slices of
  the whole attention (offsets off the tile grid, windows, MLA's head
  dims); MoE's dispatch of a segment after the earlier segments' counts
  against the whole sequence's; ``step_layout``'s segments on the
  production meshes; the dry run of a reduced train_4k whose
  ``grad_accum`` leaves fewer rows than ``data``.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_distributed import (RUN_TIMEOUT_S, SEQ_ATOL, SERVE_N,
                                    SHARD_RTOL, WORLD, _init, _mesh, _rel,
                                    _serve_unsharded)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
ARCHS = ("qwen2_72b", "mamba2_2_7b", "recurrentgemma_2b", "deepseek_v2_236b",
         "seamless_m4t_large_v2")
# Outside MULTI_CHUNK every data segment holds eight positions (S 32 on
# (4, 1), 16 on (2, 2)): mamba2's reduced SSD chunk, as train_4k's 4096
# positions in 16 segments of 256 are the SSD's chunk each, and the
# conv's context of 3 fits.
# Mamba-2 with several SSD chunks of 8 in every segment, as a prefill_32k
# segment of 4096 positions on 8 data ranks holds 16 chunks of 256: each
# segment's scan starts from the state the earlier segments hand on (the
# kernels' h0), so the state enters every chunk as the unsharded chunk
# loop carries it. Name -> (mesh, batch, variant, S): two chunks a
# segment, two and a ragged third of four positions, and two on (2, 2)
# (the mixer tensor-parallel over model too; under seqpar the segments
# split over model as well).
MULTI_CHUNK = {"mamba2_2_7b/b1/4x1/S64": ((4, 1), 1, "baseline", 64),
               "mamba2_2_7b/b1/4x1/S80": ((4, 1), 1, "baseline", 80),
               "mamba2_2_7b/b1/2x2/S32": ((2, 2), 1, "baseline", 32),
               "mamba2_2_7b/seqpar/2x2/S32": ((2, 2), 1, "seqpar", 32)}
# The same in float32, as the card trains, against the unsharded float32
# step within F32_CP_RTOL of each leaf's largest entry: the largest
# reading, layer 1's dt_bias gradient (a sum with much cancellation), was
# 6.21e-6 at S 64 on (4, 1) and 4.47e-6 on (2, 2); a carried state
# rounded to bf16 on its way between segments moves them 9.4e-4 and
# 7.0e-4.
F32_MULTI_CHUNK = {"mamba2_2_7b/b1/4x1/S64/float32": ((4, 1), 1, "baseline",
                                                      64),
                   "mamba2_2_7b/seqpar/2x2/S32/float32": ((2, 2), 1,
                                                          "seqpar", 32)}
F32_CP_RTOL = 2e-5
# Train cases: name -> (arch, mesh, batch, variant, S).
TRAIN = dict(
    {f"{a}/b1/4x1": (a, (4, 1), 1, "baseline", 32) for a in ARCHS},
    **{f"{a}/b2/4x1": (a, (4, 1), 2, "baseline", 32) for a in ARCHS},
    **{f"{a}/seqpar/2x2": (a, (2, 2), 1, "seqpar", 16) for a in ARCHS},
    **{f"{a}/act2d/2x2": (a, (2, 2), 1, "act2d", 16)
       for a in ("qwen2_72b", "mamba2_2_7b", "seamless_m4t_large_v2")},
    **{name: ("mamba2_2_7b", *case) for name, case in MULTI_CHUNK.items()})
# The multi-chunk prefill: mamba2 in float64, a batch-1 prompt of
# MULTI_SERVE_S positions on (4, 1) (segments of two chunks), decode
# caches of MULTI_SERVE_LEN positions (four segments of 18).
MULTI_SERVE_S, MULTI_SERVE_LEN = 64, 72
# Prefill: batch 1 on (4, 1), prompts of CP_SERVE_S (segments of 4), the
# decode caches of CP_SERVE_LEN positions (four segments of 6).
CP_SERVE_S, CP_SERVE_LEN = 16, 24
SERVE = {a: (a, (4, 1)) for a in ARCHS}
RUNS_TIMEOUT_S = 420
# The dry run's cell: reduced train_4k at 64 positions, two rows in two
# microbatches (one row a microbatch, which four data ranks do not
# divide); the variants that split the residual stream run on (2, 2).
DRY_CP_MESH = [[4, 1], ["data", "model"]]
DRY_WHOLE_MESH = [[1, 1], ["data", "model"]]
DRY_SPLIT_MESH = [[2, 2], ["data", "model"]]
DRY_OVER = dict(reduced=True, seq_len=64, global_batch=2, grad_accum=2)
DRY_VARIANTS = ("baseline", "seqpar", "seqpar_seqshard", "act2d",
                "act2d_seqshard")
# n x the last segment's FLOPs against the unsharded step's: the last
# segment's queries visit every key, as each of the unsharded plain
# path's does (it computes the masked blocks too).
DRY_FLOP_RTOL = 0.01


# ---------------------------------------------------------------------------
# The ranks (no jax here)
# ---------------------------------------------------------------------------

def _config(arch: str, dtype: str):
    from repro_torch.configs import get_config
    extra = dict(block_kv=8) if dtype == "float64" else {}
    return get_config(arch, reduced=True).replace(dtype=dtype,
                                                  param_dtype=dtype, **extra)


def _rank_all(rank: int, run_dir: str):
    from repro_torch.launch.dryrun import VARIANTS
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime import sharding
    from test_torch_sequence_parallel import (_serve_resharded,
                                              _train_case, _whole_train)
    _init(rank, run_dir)
    inputs = torch.load(os.path.join(run_dir, "inputs.pt"))
    out = dict(train={}, serve={}, seconds={}, old={}, ref_new={})
    wholes = {}
    cases = [(name, case, "float64") for name, case in TRAIN.items()] + [
        (name, ("mamba2_2_7b", *case), "float32")
        for name, case in F32_MULTI_CHUNK.items()]
    for name, (arch, shape, B, variant, S), dtype in cases:
        t0 = time.perf_counter()
        model = Model(_config(arch, dtype))
        wide = getattr(torch, dtype)
        params = tree_map(lambda t: t.to(wide), inputs[arch]["params"])
        batch = {k: v.to(wide) if v.is_floating_point() else v
                 for k, v in inputs[arch][f"batch{B}/{S}"].items()}
        key = f"{arch}/b{B}/{S}" + ("/float32" if dtype == "float32"
                                     else "")
        if key not in wholes:
            wholes[key] = _whole_train(model, params, batch, inputs["lr"])
            out["ref_new"][key] = [t.numpy()
                                   for t in tree_leaves(wholes[key][2])]
            out["old"].setdefault(arch, [t.numpy()
                                         for t in tree_leaves(params)])
        mesh = _mesh(shape, ("data", "model"))
        with sharding.rule_overrides(VARIANTS[variant].get("rules")):
            r = _train_case(model, params, batch, mesh, wholes[key],
                            inputs["lr"])
            r["segments"] = sharding.step_layout(
                mesh, B, S, model.cfg.d_model).segment_axes
        out["train"][name] = r
        out["seconds"][name] = time.perf_counter() - t0
    torch.set_grad_enabled(False)
    for name, (arch, shape) in SERVE.items():
        t0 = time.perf_counter()
        model = Model(_config(arch, "float32"))
        params, batch = inputs[arch]["sparams"], inputs[arch]["prompts"]
        whole = _serve_unsharded(model, params, batch, CP_SERVE_LEN, SERVE_N)
        mesh = _mesh(shape, ("data", "model"))
        r = _serve_resharded(model, params, batch, mesh, CP_SERVE_LEN,
                             SERVE_N, whole)
        r["segments"] = sharding.step_layout(
            mesh, 1, CP_SERVE_S, model.cfg.d_model).segment_axes
        out["serve"][name] = r
        out["seconds"][name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = Model(_config("mamba2_2_7b", "float64"))
    params = tree_map(lambda t: t.double(), inputs["mamba2_2_7b"]["params"])
    batch = dict(tokens=inputs["multi_prompt"])
    whole = _serve_unsharded(model, params, batch, MULTI_SERVE_LEN, SERVE_N)
    mesh = _mesh((4, 1), ("data", "model"))
    r = _serve_resharded(model, params, batch, mesh, MULTI_SERVE_LEN,
                         SERVE_N, whole)
    r["segments"] = sharding.step_layout(
        mesh, 1, MULTI_SERVE_S, model.cfg.d_model).segment_axes
    out["serve_multi"] = r
    out["seconds"]["serve_multi"] = time.perf_counter() - t0
    if rank == 0:
        np.save(os.path.join(run_dir, "ranks.npy"), out, allow_pickle=True)


def _entry(rank, case, run_dir):
    dict(ranks=_rank_all)[case](rank, run_dir)
    import torch.distributed as dist
    dist.destroy_process_group()


def _dryrun(out_path: str) -> None:
    """Reduced qwen2-72B's DRY_OVER train cell under DRY_VARIANTS on
    DRY_SPLIT_MESH, and under the baseline rules on DRY_CP_MESH at each
    rank of its data axis and on DRY_WHOLE_MESH (a FAIL is recorded, not
    raised)."""
    from repro_torch.launch import dryrun
    out = {}

    def cell(key, variant, **over):
        try:
            out[key] = dryrun.run_cell("qwen2_72b", "train_4k", False,
                                       variant, dict(DRY_OVER, **over))
        except Exception as e:              # recorded as the FAIL line
            out[key] = dict(fail=f"{type(e).__name__}: {e}")
    for variant in DRY_VARIANTS:
        cell(f"split/{variant}", variant, mesh=DRY_SPLIT_MESH)
    cell("cp", "baseline", mesh=DRY_CP_MESH)
    for r in range(DRY_CP_MESH[0][0]):
        cell(f"cp/rank{r}", "baseline", mesh=DRY_CP_MESH, rank=r)
    cell("whole", "baseline", mesh=DRY_WHOLE_MESH)
    with open(out_path, "w") as f:
        json.dump(out, f)


def main(argv):
    if argv[0] == "dryrun":
        _dryrun(*argv[1:])
        return
    import torch.multiprocessing as mp
    case, run_dir = argv
    mp.spawn(_entry, args=(case, run_dir), nprocs=WORLD, join=True)


# ---------------------------------------------------------------------------
# The tests (this process has jax)
# ---------------------------------------------------------------------------

def _start(args):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                            + [str(a) for a in args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def _wait(proc, what: str, deadline: float) -> None:
    """Waits for ``proc`` until ``deadline`` (time.monotonic); the whole
    process group is killed if it overruns."""
    try:
        log, _ = proc.communicate(timeout=max(deadline - time.monotonic(),
                                              1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"{what} did not finish in {RUNS_TIMEOUT_S} s:\n"
                    f"{log.decode()[-4000:]}")
    assert proc.returncode == 0, log.decode()[-6000:]


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the dry run, draws the reference's inits, starts the four
    ranks on them, and runs the reference's side meanwhile — each arch's
    ``jax.value_and_grad`` of its loss on the batch-1 and batch-2 train
    batches, its ``Server`` on the prompt — then waits for them all:
    (ranks' results, dry-run cells, reference results)."""
    import jax
    from repro_torch.convert import lm_params_from_reference
    from test_torch_lm_mla_moe import inputs as prompts
    from test_torch_lm_mla_moe import reference_run
    from test_torch_train import STEP_LR, train_batch, train_pair
    run_dir = tmp_path_factory.mktemp("context")
    deadline = time.monotonic() + RUNS_TIMEOUT_S
    dry_path = run_dir / "dry.json"
    dry = _start(["dryrun", dry_path])
    inputs, pairs = dict(lr=STEP_LR), {}
    for i, arch in enumerate(ARCHS):
        jm, jp, m, pp = train_pair(arch, block_kv=8)
        batches = {(B, S): train_batch(m.cfg, B=B, S=S, seed=30 + B)
                   for a, _, B, _, S in TRAIN.values() if a == arch}
        sjm, sjp, sm, spp = train_pair(arch)
        _, extra, sjb, spb = prompts(sm.cfg, B=1, S=CP_SERVE_S,
                                     seed=140 + i)
        inputs[arch] = dict(params=pp, sparams=spp, prompts=spb,
                            **{f"batch{B}/{S}": b for (B, S), (_, b)
                               in batches.items()})
        pairs[arch] = (jm, jp, batches, m.cfg, sjm, sjp, sm.cfg, sjb, extra)
    inputs["multi_prompt"] = torch.from_numpy(np.random.default_rng(
        150).integers(0, pairs["mamba2_2_7b"][3].vocab,
                      (1, MULTI_SERVE_S)).astype(np.int32))
    torch.save(inputs, os.path.join(run_dir, "inputs.pt"))
    ranks = _start(["ranks", run_dir])
    ref = {}
    for arch, (jm, jp, batches, cfg, sjm, sjp, scfg, sjb,
               extra) in pairs.items():
        for (B, S), (jb, _) in batches.items():
            jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
            ref[f"{arch}/b{B}/{S}"] = dict(
                loss=float(jloss),
                grads=[t.numpy() for t in _leaves(lm_params_from_reference(
                    jgrads, cfg))])
        tokens, logits, _, steps, _ = reference_run(sjm, sjp, scfg, sjb,
                                                    extra, SERVE_N + 1)
        ref[arch] = dict(tokens=np.asarray(tokens),
                         logits=np.asarray(logits),
                         steps=[np.asarray(s) for s in steps])
    jm, jp, _, cfg = pairs["mamba2_2_7b"][:4]
    tokens = reference_run(jm, jp, cfg, dict(tokens=jax.numpy.asarray(
        inputs["multi_prompt"].numpy())), {}, SERVE_N + 1)[0]
    ref["serve_multi"] = dict(tokens=np.asarray(tokens))
    _wait(ranks, "four gloo ranks", deadline)
    out = np.load(os.path.join(run_dir, "ranks.npy"),
                  allow_pickle=True).item()
    _wait(dry, "the dry run", deadline)
    with open(dry_path) as f:
        cells = json.load(f)
    return out, cells, ref


@pytest.mark.parametrize("case", list(TRAIN))
def test_context_parallel_train_step_matches_unsharded_and_reference(
        runs, case):
    """In float64: the layout splits the sequence over ``data`` (under
    ``seqpar`` the segments over ``model`` too, under ``act2d`` the
    embedding); the sharded step's loss and gradient norm within
    SHARD_RTOL of the unsharded step's, every leaf's gradient (the rank's
    blocks gathered) and every updated parameter within SHARD_RTOL of the
    leaf's largest entry of the unsharded step's (the segments' float32
    attention, SSD, recurrences and loss round in another order: a
    gather's backward sums the later segments' parts); the loss within
    LOSS_RTOL and each gradient within GRAD_REL of the reference's
    ``jax.value_and_grad``; every updated parameter within SHARD_RTOL of
    the unsharded AdamW step on the sharded gradients and within
    test_torch_train's limits of the unsharded step's updates."""
    from repro_torch.runtime import sharding
    from test_torch_train import GRAD_REL, LOSS_RTOL, assert_same_update
    out, _, ref = runs
    arch, shape, B, variant, S = TRAIN[case]
    key = f"{arch}/b{B}/{S}"
    r = out["train"][case]
    assert r["segments"] == ("data",), r["segments"]
    assert r["split"] == dict(baseline=None, seqpar=sharding.SEQ,
                              act2d=sharding.EMBED)[variant]
    assert abs(r["sharded_loss"] - r["loss"]) <= SHARD_RTOL * r["loss"]
    assert abs(r["sharded_grad_norm"] - r["grad_norm"]) <= \
        SHARD_RTOL * r["grad_norm"]
    assert max(r["grad_rel"]) <= SHARD_RTOL, max(r["grad_rel"])
    assert max(r["step_rel"]) <= SHARD_RTOL, max(r["step_rel"])
    want = ref[key]
    assert r["sharded_loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert len(r["grads"]) == len(want["grads"])
    for a, b in zip(r["grads"], want["grads"]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_REL * np.abs(b).max())
    assert_same_update(out["old"][arch], r["new"], out["ref_new"][key])


@pytest.mark.parametrize("case", list(F32_MULTI_CHUNK))
def test_float32_multi_chunk_train_step_matches_unsharded_and_reference(
        runs, case):
    """Mamba-2 in float32 with two SSD chunks in every segment: the
    sharded step's loss and gradient norm within SHARD_RTOL of the
    unsharded float32 step's, every leaf's gradient and updated parameter
    within F32_CP_RTOL of the leaf's largest entry of its (a carried state
    rounded below float32 between segments misses it), the loss within
    LOSS_RTOL and each gradient within GRAD_REL of the reference's
    ``jax.value_and_grad``."""
    from test_torch_train import GRAD_REL, LOSS_RTOL
    out, _, ref = runs
    shape, B, variant, S = F32_MULTI_CHUNK[case]
    r = out["train"][case]
    assert r["segments"] == ("data",), r["segments"]
    assert abs(r["sharded_loss"] - r["loss"]) <= SHARD_RTOL * r["loss"]
    assert abs(r["sharded_grad_norm"] - r["grad_norm"]) <= \
        SHARD_RTOL * r["grad_norm"]
    assert max(r["grad_rel"]) <= F32_CP_RTOL, max(r["grad_rel"])
    assert max(r["step_rel"]) <= F32_CP_RTOL, max(r["step_rel"])
    want = ref[f"mamba2_2_7b/b{B}/{S}"]
    assert r["sharded_loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    for a, b in zip(r["grads"], want["grads"], strict=True):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_REL * np.abs(b).max())


def test_multi_chunk_prefill_and_decode_match_unsharded(runs):
    """Mamba-2 in float64, a batch-1 prefill of MULTI_SERVE_S positions in
    four segments of two SSD chunks each over ``data``: each segment's
    scan runs from the state the earlier ones hand on, and the prefill's
    cache holds the state after the last. Its last logits and every
    decode step's on the segments' caches within SEQ_ATOL and SHARD_RTOL
    of the unsharded steps', the same greedy tokens, which are the
    reference ``Server``'s on the same prompt."""
    out, _, ref = runs
    r = out["serve_multi"]
    assert r["segments"] == ("data",), r["segments"]
    assert r["whole_max_abs"] <= SEQ_ATOL, r["whole_max_abs"]
    assert r["whole_rel"] <= SHARD_RTOL, r["whole_rel"]
    assert r["tokens_equal"]
    np.testing.assert_array_equal(r["tokens"], ref["serve_multi"]["tokens"])


@pytest.mark.parametrize("arch", list(SERVE))
def test_context_parallel_prefill_and_decode_match_unsharded_and_reference(
        runs, arch):
    """A batch-1 prefill with the prompt in four segments over ``data``:
    its last logits (the last segment's, on every rank) within SEQ_ATOL
    of the unsharded prefill's (and within SHARD_RTOL of their largest
    entry); its cache (each attention layer's the segment's positions)
    gathered, spliced into the decode cache and placed again, every
    decode step's logits likewise against the unsharded steps', the same
    greedy tokens, which are the reference ``Server``'s, and the logits
    within test_torch_lm's float32 limits of its."""
    from test_torch_lm import F32_TOL
    out, _, ref = runs
    r = out["serve"][arch]
    assert r["segments"] == ("data",), r["segments"]
    assert r["whole_max_abs"] <= SEQ_ATOL, r["whole_max_abs"]
    assert r["whole_rel"] <= SHARD_RTOL, r["whole_rel"]
    assert r["tokens_equal"]
    want = ref[arch]
    np.testing.assert_array_equal(r["tokens"], want["tokens"])
    np.testing.assert_allclose(r["prefill"], want["logits"], **F32_TOL)
    for port, jax_step in zip(r["decode"], want["steps"]):
        np.testing.assert_allclose(port, jax_step, **F32_TOL)


def test_dry_run_counts_the_context_parallel_cell(runs):
    """Reduced qwen2-72B's train_4k at one row a microbatch: no FAIL under
    the baseline rules on (4, 1) (the sequence in four segments over
    ``data``) nor under the split variants on (2, 2) (two segments, the
    residual stream split over ``model`` within them); the cell counts
    the last segment's rank and says so; the K/V all-gathers and their
    backwards' reduce-scatters are among the collectives. Each segment's
    queries attend one segment of keys more than the previous segment's
    (the counts grow by one step, Δ > 0), and the last segment's
    queries attend every key, as every query of the unsharded plain
    path does (which computes the masked blocks too): n times its count
    is the unsharded count within DRY_FLOP_RTOL, and the segments'
    counts sum to that less the causal blocks they skip, Δ n (n - 1) /
    2."""
    _, cells, _ = runs
    fails = {k: c["fail"] for k, c in cells.items() if "fail" in c}
    assert not fails, fails
    for variant in DRY_VARIANTS:
        c = cells[f"split/{variant}"]
        assert c["counted_segment"] == [1, 2] and c["counted_rank"] == 2, c
        assert c["flops_per_device"] > 0
    n = DRY_CP_MESH[0][0]
    last = cells["cp"]
    assert last["counted_segment"] == [n - 1, n]
    assert last["counted_rank"] == n - 1
    assert last["flops_per_device"] == \
        cells[f"cp/rank{n - 1}"]["flops_per_device"]
    assert last["collectives"]["all-gather"] > 0
    assert last["collectives"]["reduce-scatter"] > 0
    flops = [cells[f"cp/rank{r}"]["flops_per_device"] for r in range(n)]
    steps = np.diff(flops)
    assert steps[0] > 0 and np.all(steps == steps[0]), flops
    whole = cells["whole"]["flops_per_device"]
    assert abs(n * flops[-1] / whole - 1) <= DRY_FLOP_RTOL, (flops, whole)
    assert sum(flops) == n * flops[-1] - steps[0] * n * (n - 1) // 2


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------

# (B, Sq, q_offset, Kh, G, D, Dv, kind, window, block_kv): offsets on and
# off the kernels' 128-row and 128-key tiles, windows, MLA's head dims.
OFFSET_CASES = [(1, 24, 40, 2, 2, 16, 16, "causal", 0, 16),
                (2, 33, 95, 1, 3, 8, 8, "causal", 0, 32),
                (1, 20, 128, 2, 1, 16, 16, "sliding", 50, 64),
                (1, 16, 7, 1, 2, 24, 16, "causal", 0, 8),
                (1, 40, 200, 2, 2, 8, 8, "sliding", 300, 128)]


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_offset_attention_is_a_slice_of_the_whole(case):
    """The plain attention of a segment's Sq queries at ``q_offset``
    against the prefix's q_offset + Sq keys is rows [q_offset, q_offset +
    Sq) of the whole prefix's attention, within 1e-6 on float64 inputs
    (the plain versions score in float32; the same scores, and the
    blocked twin's blocks start at key 0 either way):
    ``attention_ref`` and ``flash_attention_ref`` (the kernels' plain
    versions), ``flash_attention_blocked`` (the wrappers' backward) and
    ``models.attention.prefill_attention`` (the model's path on the CPU),
    whose causal call at an offset that does not end at the last key
    raises."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref, flash_attention_blocked, flash_attention_ref)
    from repro_torch.models.attention import prefill_attention
    B, Sq, off, Kh, G, D, Dv, kind, window, bk = case
    S = off + Sq
    g = torch.Generator().manual_seed(Sq + off)
    q = torch.randn((B, S, Kh, G, D), generator=g, dtype=torch.float64)
    k = torch.randn((B, S, Kh, D), generator=g, dtype=torch.float64)
    v = torch.randn((B, S, Kh, Dv), generator=g, dtype=torch.float64)
    scale = 1.0 / np.sqrt(D)
    kw = dict(causal=True, window=window if kind == "sliding" else 0,
              scale=scale)
    whole = flash_attention_ref(q, k, v, **kw)[:, off:]
    seg = q[:, off:]
    got = dict(
        ref=flash_attention_ref(seg, k, v, q_offset=off, **kw),
        blocked=flash_attention_blocked(seg, k, v, block_kv=bk,
                                        q_offset=off, **kw),
        model=prefill_attention(seg, k, v, kind=kind, window=window,
                                block_kv=bk, softmax_scale=np.float64(scale),
                                q_offset=off))
    bh = attention_ref(seg.permute(0, 2, 3, 1, 4).reshape(-1, Sq, D),
                       k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
                       .reshape(-1, S, D),
                       v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
                       .reshape(-1, S, Dv), q_offset=off, **kw)
    got["bh"] = bh.view(B, Kh, G, Sq, Dv).permute(0, 3, 1, 2, 4)
    for name, t in got.items():
        assert torch.allclose(t, whole, rtol=0, atol=1e-6), name
    with pytest.raises(ValueError, match="last positions"):
        prefill_attention(seg, k[:, :-1], v[:, :-1], kind=kind,
                          window=window, q_offset=off)


@pytest.mark.parametrize("segments", [2, 4])
def test_moe_dispatch_of_a_segment_keeps_the_whole_dispatch(segments):
    """Capacity C from the whole sequence; each segment's dispatch after
    the earlier segments' per-expert counts (``before``) keeps exactly
    the assignments the whole sequence's dispatch keeps, at the same
    (expert, slot), with C small enough that some are dropped."""
    from repro_torch.models import moe
    B, S, k, E, C = 2, 24, 2, 4, 7
    ids = torch.from_numpy(np.random.default_rng(segments).integers(
        0, E, (B, S, k)))
    sort_idx, keep, e_idx, slot = moe.dispatch(ids, k, E, C)

    def kept(sort_idx, keep, e_idx, slot, first):
        pos = sort_idx + first * k          # assignments in token order
        return {(b, int(pos[b, i]), int(e_idx[b, i]), int(slot[b, i]))
                for b in range(B) for i in range(keep.shape[1])
                if keep[b, i]}
    want = kept(sort_idx, keep, e_idx, slot, 0)
    assert 0 < len(want) < B * S * k          # some assignments dropped
    got, n = set(), S // segments
    for r in range(segments):
        seg = ids[:, r * n:(r + 1) * n]
        before = torch.zeros((B, E), dtype=torch.int64).scatter_add_(
            1, ids[:, :r * n].reshape(B, -1),
            torch.ones_like(ids[:, :r * n].reshape(B, -1)))
        got |= kept(*moe.dispatch(seg, k, E, C, before=before), r * n)
    assert got == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_segments_on_the_production_meshes(multi_pod):
    """On the 16 x 16 and 2 x 16 x 16 meshes, for every arch: a train_4k
    microbatch of one row (``grad_accum`` 256) and a batch-1 prefill split
    the sequence into 16 segments over ``data`` under every variant — and
    ``seqpar`` the segments over ``model`` within them, ``act2d`` the
    embedding — a decode token splits nothing, and a batch that ``data``
    divides keeps every position. An embedding split over ``data``,
    which no rule set of the reference makes, raises."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.dryrun import VARIANTS
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.runtime import sharding
    mesh = production_mesh_shape(multi_pod=multi_pod)
    for arch in list_archs():
        d = get_config(arch).d_model
        for variant, v in VARIANTS.items():
            with sharding.rule_overrides(v.get("rules")):
                for seq in (4096, 32768):
                    lay = sharding.step_layout(mesh, 1, seq, d)
                    assert lay.segment_axes == ("data",), (arch, variant)
                    assert lay.segment_ways == 16
                    assert lay.split == (
                        sharding.SEQ if variant.startswith("seqpar") else
                        sharding.EMBED if variant.startswith("act2d")
                        else None), (arch, variant)
                assert sharding.step_layout(mesh, 1, 1, d).segment_axes == ()
                assert sharding.step_layout(mesh, 32, 4096,
                                            d).segment_axes == ()
    with sharding.rule_overrides({"act_seq": (), "act_embed": ("data",)}):
        with pytest.raises(NotImplementedError, match="act_embed over data"):
            sharding.step_layout(mesh, 1, 4096, 8192)


if __name__ == "__main__":
    main(sys.argv[1:])
