"""Uniform model API, as in ``repro/models/api.py``, for the families the
port carries so far: dense transformers (sliding windows and post-norms
included, with the uniform cache: neither the fp8 KV cache nor gemma2's
ring cache yet), and rwkv6.

  init(gen)                                  -> params (on gen.device)
  init_cache(batch, max_len, device)         -> dense: {"k","v"} (L,B,S,Hkv,D);
                                                rwkv: the recurrent state
  prefill(params, cache, tokens, lengths)    -> (last_logits, cache)
  prefill_chunk(params, cache, chunk, starts, take=None) -> (logits, cache)
                                                (None for rwkv: no
                                                positional cache to extend)
  decode(params, cache, tokens, lengths)     -> (logits, cache)

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


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "rwkv":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen: rwkv6.init_lm(gen, cfg),
            init_cache=lambda b, s, device: rwkv6.init_state(cfg, b, device),
            prefill=lambda p, c, t, l: rwkv6.prefill(p, c, t, l, cfg),
            decode=lambda p, c, t, l: rwkv6.decode(p, c, t, l, cfg),
        )
    # the JAX package's ``transformer._use_ring``: gemma2's window-sized
    # ring cache, a per-layer cache the port does not carry yet
    ring = cfg.window_sized_cache and cfg.local_global_alternating \
        and not cfg.scan_layers
    if cfg.family != "dense" or cfg.kv_cache_quant or ring:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port serves dense models without an "
            "fp8 KV cache or a ring cache, and rwkv6, so far; the other "
            "families and cache variants come with later slices "
            "(ROADMAP.md)")
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
