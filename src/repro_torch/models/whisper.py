"""Whisper-style encoder-decoder (arXiv:2212.04356) in PyTorch.

Counterpart of ``repro/models/whisper.py``. The conv frontend is a stub,
as in JAX: ``frames`` are precomputed frame embeddings (B, S_enc, d_model);
positions are sinusoidal. The encoder's self-attention and the decoder's
cross-attention are bidirectional (``MaskSpec("full")``), which the JAX
package computes through XLA, not a Pallas kernel: here they are plain
torch ops (``layers.attention_scores``). The decoder's self-attention runs
the kernels as the dense model's does: a causal prefill through the
chunked-prefill kernel, a ``lengths`` decode through the paged one.

Cache (every leaf has its slot on axis 1):
  {"k", "v": (L, B, max_len, Hkv, D), the decoder's self-attention;
   "cross_k", "cross_v": (L, B, S_enc, Hkv, D), the encoder output's K/V}

Entry points:
  init_lm(gen, cfg)                                      -> params
  init_cache(cfg, batch, max_len, enc_len, device)       -> cache
  prefill(params, cache, frames, tokens, lengths, cfg)   -> (last_logits, cache)
  decode(params, cache, tokens, lengths, cfg)            -> (logits, cache)
  forward_train(params, frames, tokens, cfg)             -> logits (B, S, V)
  lm_loss(params, batch, cfg)                            -> scalar

Unlike the JAX functions, prefill and decode update ``cache`` IN PLACE and
return the same dict: the self K/V are written into it, and a prefill puts
its cross K/V in the dict in place of the ones there (their S_enc is the
frames', as in JAX).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.layers import MaskSpec, ModelConfig

# rows of the decoder's sinusoid table before a prompt's own (JAX's)
DEC_POSITIONS = 8192


def sinusoid_positions(s: int, d: int, dtype, device=None) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def init_lm(gen: torch.Generator, cfg: ModelConfig):
    """Random weights from ``gen`` (on the device they go to), with the JAX
    initialisers' distributions."""
    dev = gen.device
    n_enc, n_dec = cfg.encoder_layers or cfg.num_layers, cfg.num_layers
    enc = {
        "norm_attn": L.init_norm(cfg, dev, stack=n_enc),
        "attn": L.init_attention(gen, cfg, stack=n_enc),
        "norm_mlp": L.init_norm(cfg, dev, stack=n_enc),
        "mlp": L.init_mlp(gen, cfg, stack=n_enc),
    }
    dec = {
        "norm_self": L.init_norm(cfg, dev, stack=n_dec),
        "self_attn": L.init_attention(gen, cfg, stack=n_dec),
        "norm_cross": L.init_norm(cfg, dev, stack=n_dec),
        "cross_attn": L.init_attention(gen, cfg, stack=n_dec),
        "norm_mlp": L.init_norm(cfg, dev, stack=n_dec),
        "mlp": L.init_mlp(gen, cfg, stack=n_dec),
    }
    return {"embed": L.init_embedding(gen, cfg), "enc_blocks": enc,
            "dec_blocks": dec, "enc_norm": L.init_norm(cfg, dev),
            "final_norm": L.init_norm(cfg, dev)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device):
    kvshape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cross = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.dtype, device=device)
            for name, shape in (("k", kvshape), ("v", kvshape),
                                ("cross_k", cross), ("cross_v", cross))}


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, d_model), the stub frontend's output."""
    b, s, d = frames.shape
    x = frames + sinusoid_positions(s, d, frames.dtype, frames.device)[None]
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)
    for bp in L.unstack(params["enc_blocks"]):
        h = L.apply_norm(bp["norm_attn"], x, cfg)
        attn, _ = L.apply_attention(bp["attn"], h, cfg, positions=positions,
                                    mask=MaskSpec("full"), rope=False)
        x = tp.keep(x + attn, x)
        h = L.apply_norm(bp["norm_mlp"], x, cfg)
        x = tp.keep(x + L.apply_mlp(bp["mlp"], h, cfg), x)
    return L.apply_norm(params["enc_norm"], x, cfg)


def compute_cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig):
    """Per-decoder-layer K/V over the encoder output: (L, B, S_enc, Hkv, D)."""
    kvs = [L.compute_kv(p, enc_out, cfg)
           for p in L.unstack(params["dec_blocks"]["cross_attn"])]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _dec_block(bp, x, cfg: ModelConfig, *, positions, mask, kv, cross_kv,
               cache_positions, lengths, tables):
    h = L.apply_norm(bp["norm_self"], x, cfg)
    attn, _ = L.apply_attention(
        bp["self_attn"], h, cfg, positions=positions, mask=mask, kv_cache=kv,
        cache_positions=cache_positions, lengths=lengths, rope=False,
        tables=tables)
    x = tp.keep(x + attn, x)
    h = L.apply_norm(bp["norm_cross"], x, cfg)
    cross, _ = L.apply_attention(
        bp["cross_attn"], h, cfg, positions=positions, mask=MaskSpec("full"),
        cross_kv=cross_kv, rope=False)
    x = tp.keep(x + cross, x)
    h = L.apply_norm(bp["norm_mlp"], x, cfg)
    return tp.keep(x + L.apply_mlp(bp["mlp"], h, cfg), x)


def _run_decoder(params, x, cfg: ModelConfig, *, positions, mask, cache,
                 cache_positions, lengths=None):
    """Every decoder layer over ``x``; the self K/V are written into
    ``cache`` in place. A decode's block table is built once."""
    tables = {}
    if mask.kind == "lengths":
        tables["pages"] = L.decode_block_table(*cache["k"].shape[1:3],
                                               x.device)
    for i in range(cfg.num_layers):
        x = _dec_block(
            L.layer(params["dec_blocks"], i), x, cfg, positions=positions,
            mask=mask, kv=(cache["k"][i], cache["v"][i]),
            cross_kv=(cache["cross_k"][i], cache["cross_v"][i]),
            cache_positions=cache_positions, lengths=lengths, tables=tables)
    return x, cache


def _dec_embed(params, tokens, start, cfg: ModelConfig):
    """Token embeddings plus the sinusoid rows start .. start + S of a table
    of ``DEC_POSITIONS`` + S rows, as JAX's."""
    x = L.embed(params["embed"], tokens, cfg)
    s = tokens.shape[1]
    pos = sinusoid_positions(DEC_POSITIONS + s, cfg.d_model, x.dtype,
                             x.device)
    idx = start.long()[:, None] + torch.arange(s, device=x.device)[None]
    return x + pos[idx]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def prefill(params, cache, frames, tokens, lengths, cfg: ModelConfig):
    """Encode + cross-K/V precompute + the decoder prompt's prefill (self
    K/V written at [0, S)). Returns (logits at lengths - 1 (B, V), cache)."""
    enc = encode(params, frames, cfg)
    cache["cross_k"], cache["cross_v"] = compute_cross_kv(params, enc, cfg)
    b, s = tokens.shape
    zero = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    x = _dec_embed(params, tokens, zero, cfg)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, cache = _run_decoder(params, x, cfg, positions=positions,
                            mask=MaskSpec("causal"), cache=cache,
                            cache_positions=zero)
    x = L.apply_norm(params["final_norm"], x, cfg)
    idx = (lengths.long() - 1).clamp(0, s - 1)
    last = L.take_rows(x, idx)
    return L.unembed(params["embed"], last[:, None], cfg)[:, 0], cache


def decode(params, cache, tokens, lengths, cfg: ModelConfig):
    """One decode step of tokens (B,), written at position lengths[b].
    Returns (logits (B, V), cache)."""
    x = _dec_embed(params, tokens[:, None], lengths, cfg)
    x, cache = _run_decoder(params, x, cfg, positions=lengths.long()[:, None],
                            mask=MaskSpec("lengths"), cache=cache,
                            cache_positions=lengths, lengths=lengths)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache


def forward_train(params, frames, tokens, cfg: ModelConfig):
    """Teacher forcing, as the JAX ``forward_train``: frames (B, S_enc, d)
    through the encoder ("full" attention), the cross K/V, then tokens
    (B, S) through the decoder, whose self-attention is causal over its own
    K/V (the JAX model's attention over a zero cache of S rows), each
    decoder block under full rematerialisation. Returns logits (B, S, V)."""
    enc = encode(params, frames, cfg)
    ck, cv = compute_cross_kv(params, enc, cfg)
    b, s = tokens.shape
    zero = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    x = _dec_embed(params, tokens, zero, cfg)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i, bp in enumerate(L.unstack(params["dec_blocks"])):
        block = L.remat(functools.partial(
            _dec_block, cfg=cfg, positions=positions,
            mask=MaskSpec("causal"), kv=None, cross_kv=(ck[i], cv[i]),
            cache_positions=None, lengths=None, tables={}), "full")
        x = block(bp, x)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def lm_loss(params, batch, cfg: ModelConfig):
    """batch {frames, tokens (B, S), labels (B, S)} -> the mean
    cross-entropy. Tokens and labels of different widths raise: the
    synthetic stream gives S + 1 token columns against S labels when its
    ``seq`` is below ``dec_len``, where the JAX loss fails on the shapes
    (ROADMAP.md, deliberate deviations)."""
    tokens, labels = batch["tokens"], batch["labels"]
    if tokens.shape[1] != labels.shape[1]:
        raise ValueError(
            f"whisper lm_loss: {tokens.shape[1]} token columns against "
            f"{labels.shape[1]} labels (a synthetic stream whose seq is "
            "below its dec_len gives seq + 1 tokens); use seq >= dec_len")
    return L.softmax_xent(forward_train(params, batch["frames"], tokens, cfg),
                          labels)
