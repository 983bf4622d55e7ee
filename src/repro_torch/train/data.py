"""Deterministic synthetic token stream, in PyTorch.

Counterpart of ``repro/train/data.py``: the same numpy draws from the same
generator, so a batch depends only on (seed, step) and a restarted job
resumes without drift (a checkpoint stores only the step), returned as
tensors on the device the caller names: {tokens, labels} int32, plus
``frames`` (encdec) or ``prefix_embeds`` (vlm) in the model's dtype, drawn
in f64, rounded to f32 and then to that dtype, as JAX rounds them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.layers import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    seed: int = 0
    dec_len: int = 64          # decoder tokens (encdec)


class SyntheticLM:
    """Zipf-ish token stream with local structure (repeated n-grams) so the
    loss decreases during the example training runs."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, device):
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)

    def _tensor(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.data.seed << 20) ^ step)
        b, s, v = self.data.batch, self.data.seq, self.cfg.vocab_size
        # zipfian marginal
        ranks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        toks = np.minimum(ranks, v - 1).astype(np.int32)
        # inject copyable bigram structure: x[t] = x[t-2] with prob .3
        mask = rng.random((b, s + 1)) < 0.3
        toks[:, 2:] = np.where(mask[:, 2:], toks[:, :-2], toks[:, 2:])
        out = {"tokens": self._tensor(toks[:, :-1]),
               "labels": self._tensor(toks[:, 1:])}
        if self.cfg.family == "encdec":
            frames = rng.normal(size=(b, s, self.cfg.d_model)) * 0.1
            d = self.data.dec_len
            out = {"tokens": self._tensor(toks[:, :d]),
                   "labels": self._tensor(toks[:, 1:d + 1]),
                   "frames": self._tensor(frames.astype(np.float32),
                                          self.cfg.dtype)}
        if self.cfg.family == "vlm":
            pe = rng.normal(size=(b, self.cfg.num_patches,
                                  self.cfg.vision_feature_dim)) * 0.1
            out["prefix_embeds"] = self._tensor(pe.astype(np.float32),
                                                self.cfg.dtype)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
