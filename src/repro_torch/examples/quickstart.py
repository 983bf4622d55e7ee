"""Quickstart: build a model from the registry, prefill a prompt and decode
8 tokens, then take 3 training steps, on the card unless the caller asks
for the CPU.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [arch] \\
        [--device cpu]

Counterpart of ``examples/quickstart.py``, with its sizes: the reduced
(SMOKE) config of ``arch`` (default gemma2-2b), 2 prompts of 12 tokens
into a 32-row cache, 8 greedy decode steps, then 3 steps of AdamW (its
defaults) on the synthetic stream at 2 x 16. An encdec model also takes
8 frames of ``d_model`` features, a VLM its patch features (``num_patches``
x ``vision_feature_dim``), as the JAX script gives them. Weights come from
a ``torch.Generator`` seeded 0 and prompts, frames and patches from one
seeded 1, both on the device. A VLM's lengths count its prefix too, as
``api.prefill`` takes them (the JAX script passes the text's 12).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_smoke
from repro_torch.models import api as model_api
from repro_torch.train import optimizer
from repro_torch.train.data import DataConfig, SyntheticLM

BATCH, PROMPT, CACHE, STEPS = 2, 12, 32, 8
FRAMES = 8                          # an encdec model's encoder frames
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 2, 16


def prompt_inputs(cfg, gen: torch.Generator) -> tuple:
    """(the model's prefill inputs, lengths) for ``BATCH`` random prompts
    of ``PROMPT`` tokens, with an encdec's frames or a VLM's patches."""
    device = gen.device
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=gen, device=device, dtype=torch.int32)
    n = PROMPT
    inputs = prompt
    if cfg.family == "encdec":
        inputs = {"frames": torch.randn((BATCH, FRAMES, cfg.d_model),
                                        generator=gen, device=device,
                                        dtype=cfg.dtype),
                  "tokens": prompt}
    elif cfg.family == "vlm":
        inputs = {"tokens": prompt,
                  "prefix_embeds": torch.randn(
                      (BATCH, cfg.num_patches, cfg.vision_feature_dim),
                      generator=gen, device=device, dtype=cfg.dtype)}
        n += cfg.num_patches
    return inputs, torch.full((BATCH,), n, dtype=torch.int32, device=device)


def generate(api, params, inputs, lengths, steps: int = STEPS,
             forced: Optional[torch.Tensor] = None) -> tuple:
    """Prefill, then ``steps`` decode steps, each fed the previous step's
    greedy token or, teacher-forced, ``forced[:, i]``. Returns (the
    logits of the prefill and of each decode step, the greedy tokens
    (B, steps + 1))."""
    cache = api.init_cache(BATCH, CACHE, lengths.device)
    with torch.no_grad():
        logits, cache = api.prefill(params, cache, inputs, lengths)
        out, tokens = [logits], [logits.argmax(-1)]
        for i in range(steps):
            tok = tokens[-1] if forced is None else forced[:, i]
            logits, cache = api.decode(params, cache,
                                       tok.to(torch.int32), lengths)
            lengths = lengths + 1
            out.append(logits)
            tokens.append(logits.argmax(-1))
    return out, torch.stack(tokens, 1)


def train(api, params, cfg, device, steps: int = TRAIN_STEPS) -> list:
    """``steps`` steps of ``optimizer.make_train_step`` from ``params`` on
    the synthetic stream; the losses. An encdec model's decoder takes
    ``TRAIN_SEQ`` tokens (``dec_len``): at the stream's default of 64 it
    would get 17 token columns against 16 labels, which the JAX script's
    loss fails on and the port's refuses."""
    data = SyntheticLM(cfg, DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                       dec_len=TRAIN_SEQ), device)
    step = optimizer.make_train_step(api.loss)
    state = optimizer.init_state(params)
    losses = []
    for i in range(steps):
        params, state, loss = step(params, state, data.batch_at(i))
        losses.append(float(loss))
        print(f"train step {i}: loss {losses[-1]:.4f}")
    return losses


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="gemma2-2b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)

    cfg = get_smoke(args.arch)      # reduced same-family config
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} device={device}")
    api = model_api.build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in optimizer.leaves(params))
    print(f"params: {n_params / 1e6:.2f}M")

    inputs, lengths = prompt_inputs(
        cfg, torch.Generator(device=device).manual_seed(1))
    logits, tokens = generate(api, params, inputs, lengths)
    print("generated:", tokens.tolist())
    losses = train(api, params, cfg, device)
    return {"logits": logits, "tokens": tokens, "losses": losses}


if __name__ == "__main__":
    main()
