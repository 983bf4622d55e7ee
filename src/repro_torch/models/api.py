"""Uniform model API, as in ``repro/models/api.py``, for the families the
port carries so far: dense transformers without a sliding window or an
fp8 KV cache.

  init(gen)                                  -> params (on gen.device)
  init_cache(batch, max_len, device)         -> {"k","v"} (L,B,S,Hkv,D)
  prefill(params, cache, tokens, lengths)    -> (last_logits, cache)
  prefill_chunk(params, cache, chunk, starts, take=None) -> (logits, cache)
  decode(params, cache, tokens, lengths)     -> (logits, cache)

The cache is updated in place (see ``models.transformer``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import transformer
from repro_torch.models.layers import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode: Callable
    prefill_chunk: Callable


def build(cfg: ModelConfig) -> ModelAPI:
    if (cfg.family != "dense" or cfg.sliding_window is not None
            or cfg.kv_cache_quant or cfg.use_post_norms):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port serves dense models without a "
            "sliding window, fp8 KV cache or post-norms so far; the other "
            "families come with later slices (ROADMAP.md)")
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: transformer.init_lm(gen, cfg),
        init_cache=lambda b, s, device: transformer.init_cache(cfg, b, s,
                                                               device),
        prefill=lambda p, c, t, l: transformer.prefill(p, c, t, l, cfg),
        decode=lambda p, c, t, l: transformer.decode(p, c, t, l, cfg),
        prefill_chunk=lambda p, c, ch, st, take=None:
            transformer.prefill_chunk(p, c, ch, st, cfg, take=take),
    )
