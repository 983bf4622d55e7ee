"""Decoder-only transformer LM in PyTorch: the dense path.

Counterpart of ``repro/models/transformer.py``. Parameters keep the JAX
package's pytree: ``blocks`` holds every layer's weights stacked along a
leading layer axis, and ``lax.scan`` over layers becomes a Python loop
over that axis. gemma2's local/global sliding windows (the per-layer
window of ``layer_windows_py``, in both attention kernels) and sandwich
post-norms are carried; its ring cache, the fp8 KV cache, MoE and VLM
prefixes wait for later slices (ROADMAP.md).

Entry points:
  init_lm(gen, cfg)                               -> params
  init_cache(cfg, batch, max_len, device)         -> {"k","v"} (L,B,S,Hkv,D)
  prefill(params, cache, tokens, lengths, cfg)    -> (last_logits, cache)
  prefill_chunk(params, cache, chunk, starts, cfg, take) -> (logits, cache)
  decode(params, cache, tokens, lengths, cfg)     -> (logits, cache)

Unlike the JAX functions, these write the new K/V into ``cache`` IN PLACE
and return the same dict.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import MaskSpec, ModelConfig

NO_WINDOW = (2 ** 31 - 1) // 2  # "window" that never masks


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_lm(gen: torch.Generator, cfg: ModelConfig):
    """Random weights from ``gen`` (on the device the weights go to), with
    the JAX initialisers' distributions."""
    n, dev = cfg.num_layers, gen.device
    blocks = {
        "norm_attn": L.init_norm(cfg, dev, stack=n),
        "attn": L.init_attention(gen, cfg, stack=n),
        "norm_mlp": L.init_norm(cfg, dev, stack=n),
        "mlp": L.init_mlp(gen, cfg, stack=n),
    }
    if cfg.use_post_norms:
        blocks["norm_attn_post"] = L.init_norm(cfg, dev, stack=n)
        blocks["norm_mlp_post"] = L.init_norm(cfg, dev, stack=n)
    return {"embed": L.init_embedding(gen, cfg), "blocks": blocks,
            "final_norm": L.init_norm(cfg, dev)}


def layer_windows_py(cfg: ModelConfig) -> list:
    if cfg.local_global_alternating and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else NO_WINDOW
                for i in range(cfg.num_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.num_layers
    return [NO_WINDOW] * cfg.num_layers


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=None):
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _block_fn(bp, x, cfg: ModelConfig, *, positions, mask: MaskSpec, window,
              kv, cache_positions, lengths=None):
    mask = MaskSpec(kind=mask.kind,
                    window=None if window >= NO_WINDOW else window,
                    q_offset=mask.q_offset)
    h = L.apply_norm(bp["norm_attn"], x, cfg)
    attn_out, new_kv = L.apply_attention(
        bp["attn"], h, cfg, positions=positions, mask=mask, kv_cache=kv,
        cache_positions=cache_positions, lengths=lengths)
    if "norm_attn_post" in bp:
        attn_out = L.apply_norm(bp["norm_attn_post"], attn_out, cfg)
    x = x + attn_out
    h = L.apply_norm(bp["norm_mlp"], x, cfg)
    mlp_out = L.apply_mlp(bp["mlp"], h, cfg)
    if "norm_mlp_post" in bp:
        mlp_out = L.apply_norm(bp["norm_mlp_post"], mlp_out, cfg)
    return x + mlp_out, new_kv


def _run_blocks(params, x, cfg: ModelConfig, *, positions, mask, cache,
                cache_positions, lengths=None):
    for i, window in enumerate(layer_windows_py(cfg)):
        x, _ = _block_fn(
            _layer(params["blocks"], i), x, cfg, positions=positions,
            mask=mask, window=window, kv=(cache["k"][i], cache["v"][i]),
            cache_positions=cache_positions, lengths=lengths)
    return x, cache


def _last_logits(params, x, idx, cfg: ModelConfig):
    """Final norm + unembed of x[b, idx[b]] -> (B, V) f32."""
    last = x[torch.arange(x.shape[0], device=x.device), idx]
    last = L.apply_norm(params["final_norm"], last[:, None], cfg)
    return L.unembed(params["embed"], last, cfg)[:, 0]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def prefill(params, cache, tokens, lengths, cfg: ModelConfig):
    """Full-prompt prefill. tokens (B, S) padded; KV written at [0, S).
    Returns (last_token_logits (B, V), cache)."""
    x = L.embed(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    zero = torch.zeros((b,), dtype=torch.int32, device=x.device)
    x, cache = _run_blocks(params, x, cfg, positions=positions,
                           mask=MaskSpec("causal"), cache=cache,
                           cache_positions=zero)
    idx = (lengths.long() - 1).clamp(0, s - 1)
    return _last_logits(params, x, idx, cfg), cache


def prefill_chunk(params, cache, chunk, starts, cfg: ModelConfig,
                  take: Optional[torch.Tensor] = None):
    """Chunked prefill: chunk (B, Sc) continues requests whose first
    ``starts[b]`` tokens are already in the cache. ``take`` (B,) selects the
    per-request last real token (chunks may be bucket-padded); default Sc."""
    x = L.embed(params["embed"], chunk, cfg)
    b, sc, _ = x.shape
    positions = starts.long()[:, None] + torch.arange(sc, device=x.device)[None]
    x, cache = _run_blocks(params, x, cfg, positions=positions,
                           mask=MaskSpec("chunk"), cache=cache,
                           cache_positions=starts, lengths=starts)
    if take is None:
        idx = torch.full((b,), sc - 1, dtype=torch.long, device=x.device)
    else:
        idx = (take.long() - 1).clamp(0, sc - 1)
    return _last_logits(params, x, idx, cfg), cache


def decode(params, cache, tokens, lengths, cfg: ModelConfig):
    """One decode step. tokens (B,) — the freshly sampled token, written at
    position lengths[b]. Returns (logits (B, V), cache)."""
    x = L.embed(params["embed"], tokens[:, None], cfg)
    positions = lengths.long()[:, None]
    x, cache = _run_blocks(params, x, cfg, positions=positions,
                           mask=MaskSpec("lengths"), cache=cache,
                           cache_positions=lengths, lengths=lengths)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache
