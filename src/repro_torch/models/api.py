"""Uniform model API, as in ``repro/models/api.py``, for the families the
port carries so far: dense transformers (sliding windows, post-norms, the
fp8 (e4m3) KV cache and gemma2's window-sized ring cache included), and
rwkv6. The other families (moe, vlm, hybrid, encdec) have configs but no
model yet, and ``build`` refuses them.

  init(gen)                                  -> params (on gen.device)
  init_cache(batch, max_len, device)         -> dense: {"k","v"} (L,B,S,Hkv,D),
                                                per-layer tuples for a ring;
                                                rwkv: the recurrent state
  prefill(params, cache, tokens, lengths)    -> (last_logits, cache)
  prefill_chunk(params, cache, chunk, starts, take=None) -> (logits, cache)
                                                (None for rwkv: no
                                                positional cache to extend)
  decode(params, cache, tokens, lengths)     -> (logits, cache)
  prepare(params)                            -> params for repeated steps
                                                (dense: per-layer views
                                                built once)

The cache or state is updated in place (see ``models.transformer``,
``models.rwkv6``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.models import rwkv6, transformer
from repro_torch.models.layers import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode: Callable
    prefill_chunk: Optional[Callable] = None
    prepare: Callable = lambda params: params


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "rwkv":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen: rwkv6.init_lm(gen, cfg),
            init_cache=lambda b, s, device: rwkv6.init_state(cfg, b, device),
            prefill=lambda p, c, t, l: rwkv6.prefill(p, c, t, l, cfg),
            decode=lambda p, c, t, l: rwkv6.decode(p, c, t, l, cfg),
        )
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port has no {cfg.family!r} model yet; "
            "it serves dense models and rwkv6 so far, the other families "
            "come with later slices (ROADMAP.md, queue 1)")
    return ModelAPI(
        cfg=cfg,
        init=lambda gen: transformer.init_lm(gen, cfg),
        init_cache=lambda b, s, device: transformer.init_cache(cfg, b, s,
                                                               device),
        prefill=lambda p, c, t, l: transformer.prefill(p, c, t, l, cfg),
        decode=lambda p, c, t, l: transformer.decode(p, c, t, l, cfg),
        prefill_chunk=lambda p, c, ch, st, take=None:
            transformer.prefill_chunk(p, c, ch, st, cfg, take=take),
        prepare=transformer.with_layer_views,
    )
