"""Training launcher: SMOKE-scale training with the port's substrate
(AdamW with an f32 master copy, the synthetic stream, atomic checkpoints,
restart-resume), on the card unless the caller asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 20 --batch 8 --seq 64 --ckpt DIR [--device cpu]

Counterpart of ``repro/launch/train.py``, with the same flags plus
``--device``. Restarting the same command resumes from the latest
checkpoint (``tests/test_torch_train.py`` drives that loop).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(pass --device cpu to run on the CPU)")

    from repro_torch.configs import get_smoke
    from repro_torch.models import api as model_api
    from repro_torch.train import checkpoint, optimizer
    from repro_torch.train.data import DataConfig, SyntheticLM

    device = torch.device(args.device)
    cfg = get_smoke(args.arch)
    api = model_api.build(cfg)
    data = SyntheticLM(cfg, DataConfig(batch=args.batch, seq=args.seq),
                       device)
    opt_cfg = optimizer.AdamWConfig(lr=args.lr, warmup_steps=20)
    step_fn = optimizer.make_train_step(api.loss, opt_cfg)

    start = 0
    params = api.init(torch.Generator(device=device).manual_seed(0))
    state = optimizer.init_state(params)
    if args.ckpt:
        latest = checkpoint.latest_step(args.ckpt)
        if latest is not None:
            tree = checkpoint.restore(args.ckpt, latest,
                                      {"params": params, "state": state},
                                      device)
            params, state = tree["params"], tree["state"]
            start = latest
            print(f"resumed from step {latest}")

    loss = torch.tensor(float("nan"))
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = data.batch_at(step)
        params, state, loss = step_fn(params, state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:5d} loss {float(loss):.4f} "
                  f"({dt / max(step - start + 1, 1):.3f}s/step)")
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt, step + 1,
                            {"params": params, "state": state})
    if args.ckpt:
        checkpoint.save(args.ckpt, args.steps,
                        {"params": params, "state": state})
    print(f"final loss {float(loss):.4f}")
    return float(loss)


if __name__ == "__main__":
    main()
