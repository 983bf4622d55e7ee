"""Uniform model API, as in ``repro/models/api.py``, for every family of
the JAX package: transformers (dense with sliding windows, post-norms, the
fp8 (e4m3) KV cache and gemma2's window-sized ring cache; moe; vlm, the
backbone behind a stub frontend's patch features), rwkv6, the hybrid
(zamba2: mamba2 blocks and a shared attention block) and the encdec
(whisper, behind a stub frame frontend).

  init(gen)                                  -> params (on gen.device)
  init_cache(batch, max_len, device)         -> dense: {"k","v"} (L,B,S,Hkv,D),
                                                per-layer tuples for a ring;
                                                rwkv, hybrid: the recurrent
                                                state (hybrid: nested, with
                                                the shared block's K/V);
                                                encdec also takes
                                                ``enc_len`` (default
                                                max(8, S // 4), as JAX)
  prefill(params, cache, inputs, lengths, ep=None)
                                             -> (last_logits, cache); inputs
                                                are tokens (B, S), for a
                                                vlm {"tokens", "prefix_embeds"}
                                                with lengths counting the
                                                prefix too (P + S), for an
                                                encdec {"frames", "tokens"}
  prefill_chunk(params, cache, chunk, starts, ep=None, take=None)
                                             -> (logits, cache)
                                                (None for rwkv, hybrid and
                                                encdec, as in JAX)
  decode(params, cache, tokens, lengths, ep=None) -> (logits, cache)
  prepare(params)                            -> params for repeated steps
                                                (dense: per-layer views
                                                built once; serving only)
  loss(params, batch, ep=None)               -> scalar mean cross-entropy
                                                under autograd (each
                                                family's ``lm_loss``; batch
                                                as ``train.data`` draws it)

``ep`` (a ``models.moe.EPInfo``) runs the MoE blocks expert-parallel, the
caller's rank holding its batch rows and its experts
(``models.transformer``); the other families take it and ignore it, as in
JAX. The cache or state is updated in place (see ``models.transformer``,
``models.rwkv6``, ``models.zamba2``, ``models.whisper``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.models.layers import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode: Callable
    loss: Callable
    prefill_chunk: Optional[Callable] = None
    prepare: Callable = lambda params: params


def _loss(lm_loss, cfg: ModelConfig) -> Callable:
    """A family's ``lm_loss`` behind ``loss(params, batch, ep=None)``, the
    ``ep`` ignored (no experts)."""
    return lambda params, batch, ep=None: lm_loss(params, batch, cfg)


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "rwkv":
        return ModelAPI(
            cfg=cfg,
            loss=_loss(rwkv6.lm_loss, cfg),
            init=lambda gen: rwkv6.init_lm(gen, cfg),
            init_cache=lambda b, s, device: rwkv6.init_state(cfg, b, device),
            prefill=lambda p, c, t, l, ep=None: rwkv6.prefill(p, c, t, l,
                                                              cfg),
            decode=lambda p, c, t, l, ep=None: rwkv6.decode(p, c, t, l, cfg),
        )
    if cfg.family == "hybrid":
        return ModelAPI(
            cfg=cfg,
            loss=_loss(zamba2.lm_loss, cfg),
            init=lambda gen: zamba2.init_lm(gen, cfg),
            init_cache=lambda b, s, device: zamba2.init_state(cfg, b, s,
                                                              device),
            prefill=lambda p, c, t, l, ep=None: zamba2.prefill(p, c, t, l,
                                                               cfg),
            decode=lambda p, c, t, l, ep=None: zamba2.decode(p, c, t, l,
                                                             cfg),
        )
    if cfg.family == "encdec":
        return ModelAPI(
            cfg=cfg,
            loss=_loss(whisper.lm_loss, cfg),
            init=lambda gen: whisper.init_lm(gen, cfg),
            init_cache=lambda b, s, device, enc_len=0: whisper.init_cache(
                cfg, b, s, enc_len or max(8, s // 4), device),
            prefill=lambda p, c, inputs, l, ep=None: whisper.prefill(
                p, c, inputs["frames"], inputs["tokens"], l, cfg),
            decode=lambda p, c, t, l, ep=None: whisper.decode(p, c, t, l,
                                                              cfg),
        )
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")

    def prefill(params, cache, inputs, lengths, ep=None):
        if isinstance(inputs, dict):
            return transformer.prefill(
                params, cache, inputs["tokens"], lengths, cfg, ep=ep,
                prefix_embeds=inputs.get("prefix_embeds"))
        return transformer.prefill(params, cache, inputs, lengths, cfg,
                                   ep=ep)

    return ModelAPI(
        cfg=cfg,
        loss=lambda params, batch, ep=None: transformer.lm_loss(
            params, batch, cfg, ep=ep),
        init=lambda gen: transformer.init_lm(gen, cfg),
        init_cache=lambda b, s, device: transformer.init_cache(cfg, b, s,
                                                               device),
        prefill=prefill,
        decode=lambda p, c, t, l, ep=None: transformer.decode(p, c, t, l,
                                                              cfg, ep=ep),
        prefill_chunk=lambda p, c, ch, st, ep=None, take=None:
            transformer.prefill_chunk(p, c, ch, st, cfg, ep=ep, take=take),
        prepare=transformer.with_layer_views,
    )
