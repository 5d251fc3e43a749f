"""Batched serving example of the PyTorch port: prefill a prompt batch
through a reduced gemma3-family model (sliding-window + global attention)
and decode greedily on the CUDA card — the counterpart of
``examples/serve_batch.py``. In bf16 on the card every prefill attention
is one call of the wgmma flash kernel (the window on the local layers).

    PYTHONPATH=src python examples_torch/serve_batch.py
    PYTHONPATH=src python examples_torch/serve_batch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.runtime import platform
from repro_torch.runtime.serve_loop import Server

B, S, NEW = 4, 128, 24


def config():
    return get_config("gemma3_4b", reduced=True).replace(
        n_layers=6, d_model=256, n_heads=4, n_kv=2, head_dim=64, d_ff=1024,
        vocab=32000, window=64)


def build(cfg, device):
    """(model, parameters drawn from seed 0 on ``device``)."""
    model = Model(cfg)
    return model, model.init(torch.Generator(device=device).manual_seed(0))


def prompts(cfg, batch: int, seq: int) -> np.ndarray:
    """[batch, seq] int32 prompt tokens from seed 1."""
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32).numpy()


def serve(model, params, toks: np.ndarray, new: int, device,
          log=print) -> np.ndarray:
    """Greedy generation of ``new`` tokens after ``toks`` through
    ``Server.generate``, with the reference's lines and asserts."""
    server = Server(model, params, device=device)
    t0 = time.time()
    out = server.generate(dict(tokens=toks), max_new=new)
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(device)
             if torch.device(device).type == "cuda" else "CPU")
    b = toks.shape[0]
    log(f"prefill {b}x{toks.shape[1]} + decode {new} tokens in {dt:.2f}s "
        f"({b * new / dt:.1f} tok/s on {where})")
    log(f"generated token ids (first sequence): {out[0].tolist()}")
    assert out.shape == (b, new)
    assert np.isfinite(out).all()
    log("OK")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    dev = platform.device(args.device)
    cfg = config()
    model, params = build(cfg, dev)
    print(f"serving {model.param_count() / 1e6:.1f}M-param gemma3-family "
          f"model (5:1 local:global, window={cfg.window})")
    serve(model, params, prompts(cfg, B, S), NEW, dev)


if __name__ == "__main__":
    main()
