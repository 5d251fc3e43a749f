"""The loss over qwen2-1.5B's first training steps on one CUDA card (an
H100), in bf16 and in float32, beside float32 on the CPU: a companion of
``chip_smoke.py`` phase 12, run from the repository root on the machine
with the card:

    python3 train_probe.py [--out FILE]

Every run takes 6 steps of ``make_train_step`` (AdamW, remat "full") on
``SyntheticTokens(vocab, S, B, seed=0)``, from the same seeded bf16 weights
(the float32 runs take them upcast, exactly):

  full   qwen2-1.5B at full width and depth (28 layers), global batch
         8 x 2048 in two microbatches (phase 12(b)): bf16 and float32 on
         the card at a cosine schedule that reaches 1e-3 at the first
         step (``FAST``), and bf16 at AdamW's default (100 warmup steps to
         3e-4), which phase 12(b) trains at;
  cut    the same width at depth 2, batch 2 x 256 (phase 12(a)'s shape):
         bf16 and float32 on the card and float32 on the CPU, at ``FAST``.

Prints the card's name and power limit, then each run's losses, grad
norms and step walls, and last all of them as one JSON line (also
written to ``--out``, if given).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

ARCH, STEPS = "qwen2_1_5b", 6
FAST = dict(peak_lr=1e-3, warmup=1, total=STEPS)
FULL = dict(batch=8, seq=2048, grad_accum=2)
CUT = dict(depth=2, batch=2, seq=256, grad_accum=1)


def bf16_weights(cfg):
    """The seeded bf16 weights phase 12 draws (``chip_smoke.lm_params``)."""
    import chip_smoke
    return chip_smoke.lm_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), 10)


def run(cfg, params, device, *, batch, seq, grad_accum, schedule=None):
    """6 steps from ``params`` on ``device``: losses, grad norms, walls."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.runtime.train_loop import make_train_step
    opt = adamw(lr=cosine_schedule(**schedule)) if schedule else adamw()
    state = opt.init(params)
    step = make_train_step(Model(cfg), opt, grad_accum=grad_accum)
    data = SyntheticTokens(cfg.vocab, seq, batch, seed=0, device=device)
    out = dict(losses=[], grad_norms=[], walls_s=[],
               lr=[opt.lr(i + 1) for i in range(STEPS)])
    for i in range(STEPS):
        t0 = time.perf_counter()
        params, state, met = step(params, state, data.batch(i))
        out["losses"].append(met["loss"].item())
        out["grad_norms"].append(met["grad_norm"].item())
        out["walls_s"].append(time.perf_counter() - t0)
    if device == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def report(name, res) -> None:
    print(f"{name}: losses {res['losses']}; grad_norms "
          f"{res['grad_norms']}; lr {res['lr']}; step walls "
          f"{[round(w, 3) for w in res['walls_s']]} s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("train_probe.py: no CUDA device available")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import to_device
    from repro_torch.optim.adamw import tree_map
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    _build.build(["flash_attention", "flash_attention_sm90"])
    f32 = dict(dtype="float32", param_dtype="float32")
    results = {}

    def record(name, fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        results[name] = fn()
        report(name, results[name])

    # Full width and depth: each run draws its weights anew (the same seed).
    cfg = get_config(ARCH)
    record("full bf16 card FAST", lambda: run(
        cfg, bf16_weights(cfg), "cuda", schedule=FAST, **FULL))
    record("full float32 card FAST", lambda: run(
        cfg.replace(**f32), tree_map(lambda t: t.float(), bf16_weights(cfg)),
        "cuda", schedule=FAST, **FULL))
    record("full bf16 card default", lambda: run(
        cfg, bf16_weights(cfg), "cuda", **FULL))
    # Cut depth, where the CPU can take the same steps.
    cut = cfg.replace(n_layers=CUT["depth"])
    shape = {k: CUT[k] for k in ("batch", "seq", "grad_accum")}
    w = bf16_weights(cut)
    record("cut bf16 card FAST", lambda: run(cut, w, "cuda", schedule=FAST,
                                             **shape))
    w32 = tree_map(lambda t: t.float(), w)
    record("cut float32 card FAST", lambda: run(
        cut.replace(**f32), w32, "cuda", schedule=FAST, **shape))
    record("cut float32 cpu FAST", lambda: run(
        cut.replace(**f32), to_device(w32, "cpu"), "cpu", schedule=FAST,
        **shape))
    out = json.dumps(dict(arch=ARCH, fast=FAST, full=FULL, cut=CUT,
                          runs=results))
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(out + "\n")
    print(out, flush=True)


if __name__ == "__main__":
    main()
