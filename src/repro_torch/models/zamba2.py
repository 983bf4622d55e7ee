"""Zamba2 (arXiv:2411.15242) in PyTorch: a Mamba2 backbone with one
*shared* attention block.

Counterpart of ``repro/models/zamba2.py``. ``num_layers`` Mamba2 blocks
(``models.mamba2``); after every ``attn_every`` of them the shared block
(one weight set) runs on ``proj(concat(hidden, original embedding))``, each
invocation with its own K/V cache. Its attention goes through
``layers.apply_attention``, hence ``kernels.ops``: the prefill under the
causal mask through the chunked-prefill kernel, a decode under ``lengths``
through the paged-decode kernel.

State (every leaf has its slot on axis 1):
  {"mamba": {"conv_x", "conv_bc", "ssd"} stacked on a leading layer axis,
   "k", "v": (n_invocations, B, max_len, Hkv, D)}

Entry points:
  init_lm(gen, cfg)                              -> params
  init_state(cfg, batch, max_len, device)        -> state
  prefill(params, state, tokens, lengths, cfg)   -> (last_logits, state)
  decode(params, state, tokens, lengths, cfg)    -> (logits, state)
  forward_train(params, tokens, cfg)             -> logits (B, S, V)
  lm_loss(params, batch, cfg)                    -> scalar

Unlike the JAX functions, prefill and decode update ``state`` IN PLACE and
return the same dict.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import tp
from repro_torch.models.layers import MaskSpec, ModelConfig

def n_shared_invocations(cfg: ModelConfig) -> int:
    return (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every


def init_lm(gen: torch.Generator, cfg: ModelConfig):
    """Random weights from ``gen`` (on the device they go to), with the JAX
    initialisers' distributions."""
    dev = gen.device
    shared = {
        "norm_attn": L.init_norm(cfg, dev),
        "attn": L.init_attention(gen, cfg),
        "norm_mlp": L.init_norm(cfg, dev),
        "mlp": L.init_mlp(gen, cfg),
        "in_proj": L._dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                 cfg.dtype),
        "out_proj": L._dense_init(gen, (cfg.d_model, cfg.d_model), cfg.dtype),
    }
    return {
        "embed": L.init_embedding(gen, cfg),
        "blocks": M2.init_block(gen, cfg, stack=cfg.num_layers),
        "shared": shared,
        "final_norm": L.init_norm(cfg, dev),
    }


def init_state(cfg: ModelConfig, batch: int, max_len: int, device):
    shape = (n_shared_invocations(cfg), batch, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {
        "mamba": M2.init_state(cfg, batch, device, stack=cfg.num_layers),
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _shared_block(sp, h, x0, cfg: ModelConfig, *, positions, mask, kv,
                  cache_positions, lengths, tables):
    a_in = torch.cat([h, x0], dim=-1) @ sp["in_proj"]
    z = L.apply_norm(sp["norm_attn"], a_in, cfg)
    attn_out, _ = L.apply_attention(
        sp["attn"], z, cfg, positions=positions, mask=mask, kv_cache=kv,
        cache_positions=cache_positions, lengths=lengths, tables=tables)
    a = tp.keep(a_in + attn_out, h)
    z = L.apply_norm(sp["norm_mlp"], a, cfg)
    a = tp.keep(a + L.apply_mlp(sp["mlp"], z, cfg), h)
    return tp.keep(h + a @ sp["out_proj"], h)


def _run(params, x, state, cfg: ModelConfig, seq_mode: str, *, positions,
         mask, cache_positions, lengths=None):
    """The mamba blocks in order, the shared block after every
    ``attn_every`` (``lax.scan`` over a segment becomes a loop); each
    layer's state and each invocation's K/V are written in place. The rope
    tables and, for a decode, the block table are built once for all
    invocations."""
    x0 = x
    tables = {"rope": L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)}
    if mask.kind == "lengths":
        tables["pages"] = L.decode_block_table(*state["k"].shape[1:3],
                                               x.device)
        if not tp.is_dt(x):              # tp.cache_attention takes lengths
            tables["kv_lengths"] = L.decode_lengths(
                lengths, state["k"].shape[2], ring=False)
    mamba = state["mamba"]
    for inv in range(n_shared_invocations(cfg)):
        lo = inv * cfg.attn_every
        for i in range(lo, min(cfg.num_layers, lo + cfg.attn_every)):
            out, new = M2.apply_block(L.layer(params["blocks"], i), x,
                                      L.layer(mamba, i), cfg, seq_mode)
            x = tp.keep(x + out, x)
            for n, value in new.items():
                mamba[n][i].copy_(value)
        x = _shared_block(
            params["shared"], x, x0, cfg, positions=positions, mask=mask,
            kv=(state["k"][inv], state["v"][inv]),
            cache_positions=cache_positions, lengths=lengths, tables=tables)
    return x, state


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def prefill(params, state, tokens, lengths, cfg: ModelConfig):
    """Prefill of tokens (B, S) from ``state`` (K/V written at [0, S)).
    Returns (logits at lengths - 1 (B, V), state)."""
    x = L.embed(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    zero = torch.zeros((b,), dtype=torch.int32, device=x.device)
    x, state = _run(params, x, state, cfg, "chunked", positions=positions,
                    mask=MaskSpec("causal"), cache_positions=zero)
    x = L.apply_norm(params["final_norm"], x, cfg)
    idx = (lengths.long() - 1).clamp(0, s - 1)
    last = L.take_rows(x, idx)
    return L.unembed(params["embed"], last[:, None], cfg)[:, 0], state


def decode(params, state, tokens, lengths, cfg: ModelConfig):
    """One decode step of tokens (B,), written at position lengths[b].
    Returns (logits (B, V), state)."""
    x = L.embed(params["embed"], tokens[:, None], cfg)
    x, state = _run(params, x, state, cfg, "decode",
                    positions=lengths.long()[:, None],
                    mask=MaskSpec("lengths"), cache_positions=lengths,
                    lengths=lengths)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)[:, 0], state


def _train_mamba(bp, x, state, cfg: ModelConfig):
    return M2.apply_block(bp, x, state, cfg, "chunked")[0]


def forward_train(params, tokens, cfg: ModelConfig):
    """tokens (B, S) -> logits (B, S, V) f32, as the JAX ``forward_train``:
    every mamba block from a fresh (zero) state in "chunked" mode (the SSD's
    chunked form when S % 64 == 0, the scan's function otherwise) under
    full rematerialisation, nothing written; the shared block's attention
    over its own K/V under the causal mask (``layers.attention_scores``),
    which is the JAX model's attention over a zero cache of S rows."""
    x = L.embed(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    x0 = x
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    tables = {"rope": L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)}
    block = L.remat(functools.partial(
        _train_mamba, state=M2.init_state(cfg, b, x.device), cfg=cfg), "full")
    blocks = L.unstack(params["blocks"])
    for inv in range(n_shared_invocations(cfg)):
        lo = inv * cfg.attn_every
        for bp in blocks[lo:lo + cfg.attn_every]:
            x = tp.keep(x + block(bp, x), x)
        x = _shared_block(params["shared"], x, x0, cfg, positions=positions,
                          mask=MaskSpec("causal"), kv=None,
                          cache_positions=None, lengths=None, tables=tables)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def lm_loss(params, batch, cfg: ModelConfig):
    return L.softmax_xent(forward_train(params, batch["tokens"], cfg),
                          batch["labels"])
