"""Train a ~100M-param dense LM for a few hundred steps with the port's
substrate (AdamW, the synthetic stream, checkpoints), on the card unless
the caller asks for the CPU.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny [steps] \\
        [--device cpu] [--ckpt DIR]

Counterpart of ``examples/train_tiny.py``; ``CFG`` is its config field for
field. The checkpoint is written only where ``--ckpt`` names a directory.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.models import api as model_api
from repro_torch.models.layers import ModelConfig
from repro_torch.train import checkpoint, optimizer
from repro_torch.train.data import DataConfig, SyntheticLM

# ~100M params: 12L x d512 x ff2048, 32k vocab
CFG = ModelConfig(
    name="tiny-100m", family="dense", num_layers=12, d_model=512,
    num_heads=8, num_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=32768,
    dtype=torch.float32,
)


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="?", default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)

    api = model_api.build(CFG)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n = sum(p.numel() for p in optimizer.leaves(params))
    print(f"{CFG.name}: {n / 1e6:.1f}M params, {args.steps} steps on "
          f"{device}")
    data = SyntheticLM(CFG, DataConfig(batch=4, seq=128), device)
    step = optimizer.make_train_step(
        api.loss, optimizer.AdamWConfig(lr=1e-3, warmup_steps=20))
    state = optimizer.init_state(params)
    loss = torch.tensor(float("nan"))
    t0 = time.perf_counter()
    for i in range(args.steps):
        params, state, loss = step(params, state, data.batch_at(i))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    if args.ckpt:
        checkpoint.save(args.ckpt, args.steps,
                        {"params": params, "state": state})
        print(f"checkpoint saved to {args.ckpt}")
    return float(loss)


if __name__ == "__main__":
    main()
