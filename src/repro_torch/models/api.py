"""Uniform model API, as in ``repro/models/api.py``, for the families the
port carries so far: transformers (dense with sliding windows, post-norms,
the fp8 (e4m3) KV cache and gemma2's window-sized ring cache; moe; vlm, the
backbone behind a stub frontend's patch features), and rwkv6. The hybrid
and encdec families have configs but no model yet, and ``build`` refuses
them.

  init(gen)                                  -> params (on gen.device)
  init_cache(batch, max_len, device)         -> dense: {"k","v"} (L,B,S,Hkv,D),
                                                per-layer tuples for a ring;
                                                rwkv: the recurrent state
  prefill(params, cache, inputs, lengths)    -> (last_logits, cache); inputs
                                                are tokens (B, S), or for a
                                                vlm {"tokens", "prefix_embeds"}
                                                with lengths counting the
                                                prefix too (P + S)
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
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port has no {cfg.family!r} model yet; "
            "it serves dense, moe and vlm transformers and rwkv6 so far, the "
            "other families come with later slices (ROADMAP.md, queue 1)")

    def prefill(params, cache, inputs, lengths):
        if isinstance(inputs, dict):
            return transformer.prefill(
                params, cache, inputs["tokens"], lengths, cfg,
                prefix_embeds=inputs.get("prefix_embeds"))
        return transformer.prefill(params, cache, inputs, lengths, cfg)

    return ModelAPI(
        cfg=cfg,
        init=lambda gen: transformer.init_lm(gen, cfg),
        init_cache=lambda b, s, device: transformer.init_cache(cfg, b, s,
                                                               device),
        prefill=prefill,
        decode=lambda p, c, t, l: transformer.decode(p, c, t, l, cfg),
        prefill_chunk=lambda p, c, ch, st, take=None:
            transformer.prefill_chunk(p, c, ch, st, cfg, take=take),
        prepare=transformer.with_layer_views,
    )
