"""Decoder-only transformer LM in PyTorch: dense, MoE and VLM backbones.

Counterpart of ``repro/models/transformer.py``. Parameters keep the JAX
package's pytree: ``blocks`` holds every layer's weights stacked along a
leading layer axis, and ``lax.scan`` over layers becomes a Python loop
over that axis. gemma2's local/global sliding windows (the per-layer
window of ``layer_windows_py``, in both attention kernels), sandwich
post-norms, the fp8 (e4m3) KV cache (``kv_cache_quant``), gemma2's
window-sized ring cache (``window_sized_cache``, decode only), MoE blocks
(``models.moe``, with arctic's parallel dense residual MLP) and a VLM's
projected patch prefix (``prefill(..., prefix_embeds=)``) are carried.

Entry points:
  init_lm(gen, cfg)                               -> params
  init_cache(cfg, batch, max_len, device)         -> {"k","v"} (L,B,S,Hkv,D),
                                                     or per-layer tuples of
                                                     (B,S_l,Hkv,D) under
                                                     ``uses_ring``
  prefill(params, cache, tokens, lengths, cfg, ep, prefix_embeds=None)
                                                  -> (last_logits, cache)
  prefill_chunk(params, cache, chunk, starts, cfg, ep, take)
                                                  -> (logits, cache)
  decode(params, cache, tokens, lengths, cfg, ep) -> (logits, cache)
  forward_train(params, tokens, cfg, ep, prefix_embeds=None)
                                                  -> logits (B, S, V)
  lm_loss(params, batch, cfg, ep)                 -> scalar

``ep`` (a ``models.moe.EPInfo``, default None) runs each MoE block
expert-parallel, as in JAX: the caller's rank holds its own batch rows
(tokens, lengths, cache) and its own experts, every other weight
replicated; the non-MoE layers run on those rows alone (attention through
the kernels) and only the MoE block communicates.

Unlike the JAX functions, the serving entry points write the new K/V into
``cache`` IN PLACE and return the same dict. Each entry point builds what
its layers share once (the rope tables and, for a decode, the block
table), and ``with_layer_views`` gives a params object its per-layer views
once, so a step's host work is one pass over the layers. The training
forward has no cache: each block attends over its own K/V
(``layers.attention_scores``, plain torch ops under autograd) and runs
under ``layers.remat``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import tp
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
    }
    if cfg.use_post_norms:
        blocks["norm_attn_post"] = L.init_norm(cfg, dev, stack=n)
        blocks["norm_mlp_post"] = L.init_norm(cfg, dev, stack=n)
    if cfg.is_moe:
        blocks["moe"] = M.init_moe(gen, cfg, stack=n)
        if cfg.moe_dense_residual_ff:
            blocks["mlp"] = L.init_mlp(gen, cfg, stack=n,
                                       d_ff=cfg.moe_dense_residual_ff)
    else:
        blocks["mlp"] = L.init_mlp(gen, cfg, stack=n)
    params = {"embed": L.init_embedding(gen, cfg), "blocks": blocks,
              "final_norm": L.init_norm(cfg, dev)}
    if cfg.vision_feature_dim:
        params["vision_proj"] = L._dense_init(
            gen, (cfg.vision_feature_dim, cfg.d_model), cfg.dtype)
    return params


def layer_windows_py(cfg: ModelConfig) -> list:
    if cfg.local_global_alternating and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else NO_WINDOW
                for i in range(cfg.num_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.num_layers
    return [NO_WINDOW] * cfg.num_layers


def cache_dtype(cfg: ModelConfig, dtype=None):
    """The JAX package's ``_cache_dtype``: e4m3 under ``kv_cache_quant``."""
    if dtype is not None:
        return dtype
    return torch.float8_e4m3fn if cfg.kv_cache_quant else cfg.dtype


def uses_ring(cfg: ModelConfig) -> bool:
    """The JAX package's ``_use_ring``: a per-layer cache whose local
    layers keep only a window-sized ring."""
    return cfg.window_sized_cache and cfg.local_global_alternating \
        and not cfg.scan_layers


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=None):
    dtype = cache_dtype(cfg, dtype)
    if uses_ring(cfg):
        shapes = [(batch, min(max_len, w), cfg.num_kv_heads, cfg.head_dim)
                  for w in layer_windows_py(cfg)]
        return {name: tuple(torch.zeros(s, dtype=dtype, device=device)
                            for s in shapes) for name in ("k", "v")}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _sizes(cache) -> list:
    """Each layer's cache length."""
    k = cache["k"]
    if isinstance(k, tuple):
        return [a.shape[1] for a in k]
    return [k.shape[2]] * k.shape[0]


def ring_layers(cache) -> list:
    """Which layers of ``cache`` are rings: as in the JAX ``_run_blocks``,
    a per-layer cache's layers shorter than its longest one (none when
    ``max_len`` fits the window)."""
    sizes = _sizes(cache)
    return [s < max(sizes) for s in sizes]


def _refuse_ring(cache, entry: str) -> None:
    if any(ring_layers(cache)):
        raise ValueError(
            f"{entry} over a window-sized ring cache: a ring is decode-only "
            "(the JAX model fails on it, or attends a short chunk under the "
            "ring mask, a wrong result; ROADMAP.md, deliberate deviations). "
            "Decode into the ring from an empty cache, or use a cache of "
            "max_len <= the window")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def with_layer_views(params):
    """``params`` plus ``"layers"``: each layer's views of the stacked
    ``blocks``, built once for the params object (a shallow copy; the
    tensors are shared). Entry points given params without it build the
    views once per call."""
    if "layers" in params:
        return params
    n = next(iter(params["blocks"]["attn"].values())).shape[0]
    return {**params, "layers": [L.layer(params["blocks"], i)
                                 for i in range(n)]}


def _block_fn(bp, x, cfg: ModelConfig, *, positions, mask: MaskSpec, window,
              kv, cache_positions, lengths=None, tables=None, ring=False,
              ep: Optional[M.EPInfo] = None, pending=None):
    """One block over the residual stream ``x + pending`` (``pending``:
    the previous block's MLP output, not yet added; None: x alone).
    Returns (x, pending, new_kv). Where the fused passes run (an RMSNorm
    model, ``L.fuses``), the MLP output is left out of x as the next
    pending, for the next norm's pass to add (``L.add_norm``); elsewhere
    it is added here and pending is None, the plain ops in their order.
    ``ring``: this layer's cache is a window-sized ring (decode only),
    written at ``cache_positions mod`` its size and read under the "ring"
    mask, which the window reduces to there."""
    if ring:
        mask = MaskSpec("ring")
        cache_positions = torch.remainder(cache_positions, kv[0].shape[1])
    else:
        mask = MaskSpec(kind=mask.kind,
                        window=None if window >= NO_WINDOW else window,
                        q_offset=mask.q_offset)
    x, h = L.add_norm(bp["norm_attn"], x, pending, cfg)
    attn_out, new_kv = L.apply_attention(
        bp["attn"], h, cfg, positions=positions, mask=mask, kv_cache=kv,
        cache_positions=cache_positions, lengths=lengths, tables=tables)
    if "norm_attn_post" in bp:
        attn_out = L.apply_norm(bp["norm_attn_post"], attn_out, cfg)
    x, h = L.add_norm(bp["norm_mlp"], x, attn_out, cfg)
    if cfg.is_moe:
        mlp_out = M.apply_moe(bp["moe"], h, cfg, ep)
        if cfg.moe_dense_residual_ff:
            mlp_out = mlp_out + L.apply_mlp(bp["mlp"], h, cfg)
    else:
        mlp_out = L.apply_mlp(bp["mlp"], h, cfg)
    if "norm_mlp_post" in bp:
        mlp_out = L.apply_norm(bp["norm_mlp_post"], mlp_out, cfg)
    if not cfg.use_layernorm and L.fuses(x, mlp_out):
        return x, mlp_out, new_kv
    return tp.keep(x + mlp_out, x), None, new_kv


def _run_blocks(params, x, cfg: ModelConfig, *, positions, mask, cache,
                cache_positions, lengths=None, ep=None):
    """Every layer over ``x``, with the tables they share built once: the
    rope tables, and for a decode one block table and one set of kernel
    lengths per distinct cache length (a ring's and the full one). Returns
    (x, pending): the residual stream is x + pending, the last block's MLP
    output left for the final norm's pass to add (None: x is the stream)."""
    layers = with_layer_views(params)["layers"]
    rot = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    sizes, rings = _sizes(cache), ring_layers(cache)
    tables = {}
    for size in set(sizes):
        tables[size] = {"rope": rot}
        if mask.kind == "lengths":
            tables[size]["pages"] = L.decode_block_table(x.shape[0], size,
                                                         x.device)
            if not tp.is_dt(x):          # tp.cache_attention takes lengths
                tables[size]["kv_lengths"] = L.decode_lengths(
                    lengths, size, ring=size < max(sizes))
    pending = None
    for i, window in enumerate(layer_windows_py(cfg)):
        x, pending, _ = _block_fn(
            layers[i], x, cfg, positions=positions, mask=mask, window=window,
            kv=(cache["k"][i], cache["v"][i]),
            cache_positions=cache_positions, lengths=lengths,
            tables=tables[sizes[i]], ring=rings[i], ep=ep, pending=pending)
    return x, pending


def _last_logits(params, x, pending, idx, cfg: ModelConfig):
    """Final norm + unembed of (x + pending)[b, idx[b]] -> (B, V) f32:
    with a pending MLP output (the fused passes), only the taken rows are
    summed, in the norm's pass."""
    last = L.take_rows(x, idx)[:, None]
    r = None if pending is None else L.take_rows(pending, idx)[:, None]
    _, last = L.add_norm(params["final_norm"], last, r, cfg)
    return L.unembed(params["embed"], last, cfg)[:, 0]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _embed_inputs(params, tokens, cfg: ModelConfig, prefix_embeds=None):
    """The token embeddings (scaled by sqrt(d_model)), after the projected
    patch prefix when ``prefix_embeds`` (B, P, vision_feature_dim) is given:
    ``prefix_embeds @ vision_proj`` in their promoted dtype, cast to the
    model's and NOT scaled, as the JAX ``_embed_inputs`` does."""
    x = L.embed(params["embed"], tokens, cfg)
    if prefix_embeds is None:
        return x
    w = params["vision_proj"]
    dt = torch.promote_types(prefix_embeds.dtype, w.dtype)
    vis = (prefix_embeds.to(dt) @ w.to(dt)).to(x.dtype)
    return torch.cat([vis, x], dim=1)


def prefill(params, cache, tokens, lengths, cfg: ModelConfig, ep=None,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Full-prompt prefill. tokens (B, S) padded; KV written at [0, S), or
    with a VLM's ``prefix_embeds`` (B, P, F) at [0, P + S), the prefix
    first. ``lengths`` counts every row the prefill writes up to the last
    real token, the prefix's included (P + S for a full text row), as in
    the JAX package: the logits are those of row ``lengths - 1`` and a
    decode continues at ``lengths``. Returns (last_token_logits (B, V),
    cache). A cache with ring layers raises (a ring is decode-only)."""
    _refuse_ring(cache, "prefill")
    x = _embed_inputs(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    zero = torch.zeros((b,), dtype=torch.int32, device=x.device)
    x, pending = _run_blocks(params, x, cfg, positions=positions,
                             mask=MaskSpec("causal"), cache=cache,
                             cache_positions=zero, ep=ep)
    idx = (lengths.long() - 1).clamp(0, s - 1)
    return _last_logits(params, x, pending, idx, cfg), cache


def prefill_chunk(params, cache, chunk, starts, cfg: ModelConfig, ep=None,
                  take: Optional[torch.Tensor] = None):
    """Chunked prefill: chunk (B, Sc) continues requests whose first
    ``starts[b]`` tokens are already in the cache. ``take`` (B,) selects the
    per-request last real token (chunks may be bucket-padded); default Sc.
    A cache with ring layers raises (a ring is decode-only)."""
    _refuse_ring(cache, "prefill_chunk")
    x = L.embed(params["embed"], chunk, cfg)
    b, sc, _ = x.shape
    positions = starts.long()[:, None] + torch.arange(sc, device=x.device)[None]
    x, pending = _run_blocks(params, x, cfg, positions=positions,
                             mask=MaskSpec("chunk"), cache=cache,
                             cache_positions=starts, lengths=starts, ep=ep)
    if take is None:
        idx = torch.full((b,), sc - 1, dtype=torch.long, device=x.device)
    else:
        idx = (take.long() - 1).clamp(0, sc - 1)
    return _last_logits(params, x, pending, idx, cfg), cache


def decode(params, cache, tokens, lengths, cfg: ModelConfig, ep=None):
    """One decode step. tokens (B,) — the freshly sampled token, written at
    position lengths[b] (a ring layer's at lengths[b] mod its size).
    Returns (logits (B, V), cache)."""
    x = L.embed(params["embed"], tokens[:, None], cfg)
    positions = lengths.long()[:, None]
    x, pending = _run_blocks(params, x, cfg, positions=positions,
                             mask=MaskSpec("lengths"), cache=cache,
                             cache_positions=lengths, lengths=lengths, ep=ep)
    _, x = L.add_norm(params["final_norm"], x, pending, cfg)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache


def _train_block(bp, x, cfg: ModelConfig, *, positions, window, tables,
                 ep=None):
    x, pending, _ = _block_fn(bp, x, cfg, positions=positions,
                              mask=MaskSpec("causal"), window=window,
                              kv=None, cache_positions=None, tables=tables,
                              ep=ep)
    return x if pending is None else x + pending


def forward_train(params, tokens, cfg: ModelConfig, ep=None,
                  prefix_embeds: Optional[torch.Tensor] = None):
    """tokens (B, S) (after a VLM's ``prefix_embeds`` (B, P, F)) -> logits
    (B, P + S, V) f32, as the JAX ``forward_train``: no cache, every layer
    under ``MaskSpec("causal")`` with its window, each block under
    ``layers.remat(cfg.remat_policy)``. The per-layer views are built here,
    in the call, by ``layers.unstack`` (views cached on a params object
    across steps would hold a freed graph)."""
    x = _embed_inputs(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    tables = {"rope": L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)}
    for bp, window in zip(L.unstack(params["blocks"]), layer_windows_py(cfg)):
        block = L.remat(functools.partial(
            _train_block, cfg=cfg, positions=positions, window=window,
            tables=tables, ep=ep), cfg.remat_policy)
        x = block(bp, x)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def lm_loss(params, batch, cfg: ModelConfig, ep=None):
    """batch {tokens (B, S), labels (B, S)[, prefix_embeds]} -> the mean
    cross-entropy; a VLM's on the text positions only (the last
    ``labels.shape[1]``)."""
    logits = forward_train(params, batch["tokens"], cfg, ep=ep,
                           prefix_embeds=batch.get("prefix_embeds"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    return L.softmax_xent(logits, labels)
