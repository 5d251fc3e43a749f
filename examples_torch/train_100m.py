"""End-to-end training driver of the PyTorch port: a ~100M-param
qwen2-family model for a few hundred steps on the CUDA card, with
checkpoint/restart fault tolerance (an injected failure at step 60
recovers from the last checkpoint) and async checkpointing — the
counterpart of ``examples/train_100m.py``, on the same runtime path
(``runtime.elastic.run_elastic``, ``checkpoint.AsyncCheckpointer``).

    PYTHONPATH=src python examples_torch/train_100m.py [--steps 200]
    PYTHONPATH=src python examples_torch/train_100m.py --device cpu

Prints each restart's cause and each commit's bytes and seconds beside
the reference's lines. The checkpoint directory must hold no checkpoint
of an earlier run: a restart would resume from it.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.models.model import Model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime import elastic, platform
from repro_torch.runtime.train_loop import make_train_step


def config():
    """~100M params: a narrow 12-layer qwen2-family decoder, float32
    parameters, bf16 compute (the config's default)."""
    return get_config("qwen2_1_5b").replace(
        n_layers=12, d_model=512, n_heads=8, n_kv=2, head_dim=64,
        d_ff=2048, vocab=32000, remat="none", param_dtype="float32")


def build(cfg, steps: int, device):
    """(model, parameters drawn from seed 0 on ``device``, AdamW on the
    reference's cosine schedule)."""
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt = adamw(lr=cosine_schedule(3e-4, 20, steps))
    return model, params, opt


def train(model, params, opt, batch_fn, *, steps: int, ckpt_dir: str,
          inject_failure: int, ckpt_every: int = 25, log=print) -> dict:
    """``steps`` AdamW steps under ``run_elastic`` (a checkpoint every
    ``ckpt_every`` steps, a failure injected after step
    ``inject_failure``, none at 0).
    ``batch_fn(step)`` gives step ``step``'s batch. Returns run_elastic's
    dict with ``losses`` and ``grad_norms`` of every step run (replays
    included), ``steps`` (the step index of each), ``walls_s`` (each
    step's wall, to its loss on the host) and ``wall_s``."""
    if latest_step(ckpt_dir) is not None:
        raise ValueError(f"{ckpt_dir} holds a checkpoint of an earlier "
                         "run; remove it or pass another --ckpt-dir")
    train_step = make_train_step(model, opt)
    device = params["embed"]["tokens"].device
    losses, gnorms, seen, walls = [], [], [], []

    def step_fn(state, batch, step):
        t0 = time.perf_counter()
        p, o = state
        gen = torch.Generator(device=device).manual_seed(step)
        p, o, metrics = train_step(p, o, batch, gen)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        walls.append(time.perf_counter() - t0)
        seen.append(step)
        if step % 20 == 0:
            log(f"step {step:4d} loss {losses[-1]:.4f} "
                f"gnorm {gnorms[-1]:.3f}")
        return (p, o)

    injector = elastic.FailureInjector(
        fail_after_steps=(inject_failure,) if inject_failure else ())
    t0 = time.time()
    out = elastic.run_elastic(
        (params, opt.init(params)), step_fn, batch_fn, num_steps=steps,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, injector=injector)
    out.update(losses=losses, grad_norms=gnorms, steps=seen, walls_s=walls,
               wall_s=time.time() - t0)
    return out


def report(out: dict, log=print) -> str:
    """The reference's closing lines, each restart's cause and each
    commit; returns the verdict (``LEARNING`` or ``check config``)."""
    for cause in out["causes"]:
        log(f"restart: {cause}")
    for c in out["commits"]:
        log(f"commit step {c['step']}: {c['bytes'] / 1e9:.3f} GB, copied "
            f"off the device in {c['copy_s']:.3f} s, written in "
            f"{c['write_s']:.3f} s")
    losses = out["losses"]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    verdict = "LEARNING" if last < first - 0.1 else "check config"
    log(f"\n{out['steps_run']} steps in {out['wall_s']:.1f}s "
        f"({out['restarts']} restart(s) from injected failure)")
    log(f"loss {first:.4f} -> {last:.4f} ({verdict})")
    return verdict


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_100m"))
    ap.add_argument("--inject-failure", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    dev = platform.device(args.device)

    cfg = config()
    model, params, opt = build(cfg, args.steps, dev)
    print(f"model: {model.param_count() / 1e6:.1f}M params")
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, device=dev)
    out = train(model, params, opt, data.batch, steps=args.steps,
                ckpt_dir=args.ckpt_dir, inject_failure=args.inject_failure,
                log=lambda s: print(s, flush=True))
    report(out)


if __name__ == "__main__":
    main()
