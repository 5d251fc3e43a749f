"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``) on the CPU, at small sizes: ``train_100m``'s elastic
training loop against the reference's jitted loop under the reference's
``run_elastic`` (the reference's weights carried across), ``serve_batch``
against the reference ``Server``, and ``geo_schedule_training``'s jobs and
summaries against the reference script's own ``job_from_dryrun`` and
``Simulator`` runs. The five scheduler examples are held in
``test_torch_examples_sched.py``.
"""
import copy
import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import telemetry as ref_telemetry
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import Model as JaxModel
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine_schedule
from repro.runtime import elastic as jelastic
from repro.runtime.serve_loop import Server as JaxServer
from repro.runtime.train_loop import make_train_step as jmake_train_step
from repro.sim import Simulator as RefSimulator
from repro.sim import summarize as ref_summarize
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import SyntheticTokens
from repro_torch.models.model import Model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from test_torch_train import UPDATE_ATOL, UPDATE_FRAC, UPDATE_TIGHT

ROOT = pathlib.Path(__file__).resolve().parents[1]

# train_100m reduced: the reference's config at 2 layers and narrow widths,
# float32 compute on both sides; B 2 x 16, 12 steps, a checkpoint every 4
# steps and a failure after step 6 (so steps 5-6 run twice).
TRAIN_OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
                  d_ff=128, vocab=256, dtype="float32")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_EVERY, TRAIN_FAIL = 12, 2, 16, 4, 6
# Each step's loss, the replays' too: float32 on both sides, sums in XLA's
# and PyTorch's orders, a few AdamW steps apart.
LOSS_RTOL = 1e-5


def load(path: pathlib.Path, name: str):
    """A script as a module, its ``main`` unrun."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name: str):
    return load(ROOT / "examples_torch" / f"{name}.py", f"port_{name}")


def ref_example(name: str):
    return load(ROOT / "examples" / f"{name}.py", f"ref_{name}")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The reference's loop and the port's example on the same weights and
    batches, with the failure: (reference dict, port dict, the initial
    parameters as numpy leaves in the port's order, the schedule's lr at
    steps 1..12, the config)."""
    ex = port_example("train_100m")
    jcfg = jax_get_config("qwen2_1_5b").replace(
        remat="none", param_dtype="float32", **TRAIN_OVER)
    cfg = ex.config().replace(**TRAIN_OVER)
    jm = JaxModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    # Converted before the reference's jitted step donates jp's buffers.
    params = lm_params_from_reference(jp, cfg)
    init = [_np(t) for t in tree_leaves(params)]
    jopt = jadamw(lr=jcosine_schedule(3e-4, 20, TRAIN_STEPS))
    jdata = JaxSyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    jstep = jax.jit(jmake_train_step(jm, jopt), donate_argnums=(0, 1))
    ref_losses = []

    def ref_step_fn(state, batch, step):
        p, o = state
        p, o, metrics = jstep(p, o, batch, jax.random.PRNGKey(step))
        ref_losses.append(float(metrics["loss"]))
        return (p, o)

    ref = jelastic.run_elastic(
        (jp, jopt.init(jp)), ref_step_fn, jdata.batch, num_steps=TRAIN_STEPS,
        ckpt_dir=str(tmp_path_factory.mktemp("ref")), ckpt_every=TRAIN_EVERY,
        injector=jelastic.FailureInjector(fail_after_steps=(TRAIN_FAIL,)))
    ref["losses"] = ref_losses

    def batch_fn(step):
        return {k: torch.from_numpy(np.array(v))
                for k, v in jdata.batch(step).items()}
    model = Model(cfg)
    opt = adamw(lr=cosine_schedule(3e-4, 20, TRAIN_STEPS))
    out = ex.train(model, params, opt, batch_fn, steps=TRAIN_STEPS,
                   ckpt_dir=str(tmp_path_factory.mktemp("port")),
                   inject_failure=TRAIN_FAIL, ckpt_every=TRAIN_EVERY,
                   log=lambda s: None)
    lrs = [opt.lr(s) for s in range(1, TRAIN_STEPS + 1)]
    return ref, out, init, lrs, cfg


def test_train_100m_losses_match_reference_loop(train_runs):
    """Every step's loss, the replayed steps' too, within LOSS_RTOL of the
    reference loop's; the same restarts and steps run."""
    ref, out, _, _, _ = train_runs
    assert (out["restarts"], out["steps_run"]) == (
        ref["restarts"], ref["steps_run"]) == (1, TRAIN_STEPS + 2)
    assert out["steps"] == [0, 1, 2, 3, 4, 5, 4, 5] + list(range(6, 12))
    assert out["causes"] == [f"RuntimeError: injected failure at step "
                             f"{TRAIN_FAIL}"]
    assert [c["step"] for c in out["commits"]] == [4, 8, 12]
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=LOSS_RTOL,
                               atol=0)
    assert all(np.isfinite(out["grad_norms"]))


def test_train_100m_final_parameters_match_reference(train_runs):
    """The final parameters' change over the run, (final - initial) / sum
    of lr over the 12 updates, against the reference's: every entry within
    UPDATE_ATOL, all but UPDATE_FRAC within UPDATE_TIGHT (AdamW turns
    float32 gradient noise into whole steps of lr); AdamW's step count the
    reference's, a Python int; the run visible, a quarter of the entries
    moving by more than a tenth of the sum of lr."""
    ref, out, init, lrs, cfg = train_runs
    (jp, jo), (pp, po) = ref["state"], out["state"]
    assert isinstance(po.step, int) and po.step == int(jo.step) == 12
    total = sum(lrs)
    want_final = [_np(t) for t in tree_leaves(lm_params_from_reference(
        jax.tree.map(np.asarray, jp), cfg))]
    mine = [_np(t) for t in tree_leaves(pp)]
    worst = tight_off = n = moved = 0
    assert len(mine) == len(want_final) == len(init) > 0
    for got, want, o in zip(mine, want_final, init):
        d = np.abs((got - o) - (want - o)) / total
        worst = max(worst, float(d.max()))
        tight_off += int((d > UPDATE_TIGHT).sum())
        moved += int((np.abs(want - o) / total > 0.1).sum())
        n += d.size
    assert worst <= UPDATE_ATOL, worst
    assert tight_off <= UPDATE_FRAC * n, (tight_off, n)
    assert moved >= n / 4, (moved, n)


def test_train_100m_failure_is_bitwise_the_clean_run(tmp_path):
    """On the CPU the port's run with the failure ends in exactly the
    clean run's state (the restored AdamW step count and moments
    included), and each replayed step's loss is bitwise its first pass."""
    ex = port_example("train_100m")
    cfg = ex.config().replace(**TRAIN_OVER)
    runs = []
    for fail in (TRAIN_FAIL, 0):
        model, params, opt = ex.build(cfg, TRAIN_STEPS, "cpu")
        data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                               device="cpu")
        runs.append(ex.train(model, params, opt, data.batch,
                             steps=TRAIN_STEPS,
                             ckpt_dir=str(tmp_path / str(fail)),
                             inject_failure=fail, ckpt_every=TRAIN_EVERY,
                             log=lambda s: None))
    faulty, clean = runs
    assert (faulty["restarts"], clean["restarts"]) == (1, 0)
    a, b = tree_leaves(faulty["state"]), tree_leaves(clean["state"])
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x == y if isinstance(x, int) else (
            x.dtype == y.dtype and torch.equal(x, y))
    first = dict(zip(clean["steps"], clean["losses"]))
    assert all(first[s] == loss for s, loss in zip(faulty["steps"],
                                                   faulty["losses"]))
    with pytest.raises(ValueError, match="earlier run"):
        model, params, opt = ex.build(cfg, TRAIN_STEPS, "cpu")
        ex.train(model, params, opt, data.batch, steps=1,
                 ckpt_dir=str(tmp_path / "0"), inject_failure=0)


def test_serve_batch_matches_reference_server():
    """serve_batch's model at 2 layers in float32: the port's example and
    the reference ``Server`` on the reference's weights and the example's
    prompts give the same greedy tokens."""
    ex = port_example("serve_batch")
    over = dict(n_layers=2, dtype="float32", param_dtype="float32")
    cfg = ex.config().replace(**over)
    jcfg = jax_get_config("gemma3_4b", reduced=True).replace(
        d_model=256, n_heads=4, n_kv=2, head_dim=64, d_ff=1024, vocab=32000,
        window=64, **over)
    jm = JaxModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    toks = ex.prompts(cfg, ex.B, ex.S)
    lines = []
    got = ex.serve(Model(cfg), lm_params_from_reference(jp, cfg), toks,
                   ex.NEW, "cpu", log=lines.append)
    want = np.asarray(JaxServer(jm, jp).generate(
        dict(tokens=jnp.asarray(toks)), max_new=ex.NEW))
    np.testing.assert_array_equal(got, want)
    assert lines[-1] == "OK" and "on CPU" in lines[0]


def _cells(tmp_path):
    """Two dry-run cells in the port's layout (and the reference's key
    names: ``roofline.t_*``, ``params``, ``arch``), one skipped file, and a
    cell of another mesh the example must not read."""
    cells = [dict(arch="mamba2_2_7b", shape="train_4k", params=2.7e9,
                  chips=256, mesh="{'data': 16, 'model': 16}",
                  roofline=dict(t_compute=0.31, t_memory=0.92,
                                t_collective=1.07, dominant="collective")),
             dict(arch="qwen2_1_5b", shape="train_4k", params=1.54e9,
                  chips=256, mesh="{'data': 16, 'model': 16}",
                  roofline=dict(t_compute=0.0292, t_memory=1.4466,
                                t_collective=0.1306, dominant="memory"))]
    for c in cells:
        (tmp_path / f"{c['arch']}.train_4k.pod1.baseline.json").write_text(
            json.dumps(c))
    (tmp_path / "dbrx_132b.train_4k.pod1.baseline.json").write_text(
        json.dumps(dict(arch="dbrx_132b", skipped=True)))
    (tmp_path / "qwen2_1_5b.train_4k.pod2.baseline.json").write_text(
        json.dumps(dict(cells[1], chips=512)))
    return cells


def test_geo_schedule_training_matches_reference(tmp_path):
    """On the same cells and chip constants (the reference's 250 W and 256
    chips): the same 60 jobs as the reference script's ``job_from_dryrun``
    loop, and the same baseline and waterwise summaries as its
    ``Simulator`` runs; the devices come from the cell, not a constant."""
    ex, ref = port_example("geo_schedule_training"), ref_example(
        "geo_schedule_training")
    cells = _cells(tmp_path)
    assert ex.load_cells(str(tmp_path)) == cells
    jobs = ex.make_jobs(cells, chip_w=ref.CHIP_W)
    rng = np.random.default_rng(0)
    want = [ref.job_from_dryrun(cells[i % len(cells)], i,
                                int(rng.integers(0, 5)),
                                float(rng.uniform(0, 2 * 86400)))
            for i in range(60)]
    assert ref.CHIPS == cells[0]["chips"]
    assert [dataclasses.asdict(j) for j in jobs] == [
        dataclasses.asdict(j) for j in want]
    lines = []
    got = ex.schedule(jobs, len(cells), "cpu", log=lines.append)
    tele = ref_telemetry.generate(days=4, seed=0)
    for name in ("baseline", "waterwise"):
        s = ref_summarize(RefSimulator(tele, np.full(5, 6)).run(
            copy.deepcopy(want), name))
        mine = dict(got[name])
        for k in ("mean_solve_ms",):          # wall time, not a result
            del s[k], mine[k]
        assert mine == s, name
    assert lines[0].startswith("60 training jobs (2 archs)")
    wide = ex.job_from_dryrun(dict(cells[0], chips=512), 0, 0, 0.0, 250.0)
    assert wide.energy_kwh == 2 * jobs[0].energy_kwh


def test_geo_schedule_training_reads_the_card_power(monkeypatch):
    """The card's name and power limit come from nvidia-smi's csv line."""
    ex = port_example("geo_schedule_training")

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"
    monkeypatch.setattr(ex.subprocess, "run", lambda *a, **k: Done())
    assert ex.card_power() == ("NVIDIA H100 80GB HBM3", 700.0)
