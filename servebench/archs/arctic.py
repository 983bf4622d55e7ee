"""Snowflake Arctic on one card of its expert-parallel group: the Llama
block with a top-k MoE beside a dense residual MLP, of which the card
holds a contiguous share of the experts (``servebench/archs``).

The configuration keeps the model's experts and the card's share apart:
the router scores all ``num_local_experts`` (the published count), and
the card holds ``held_experts`` of them, global ids ``held_expert_first``
on. Every token is routed over all of them; the layer adds the held
experts' part alone, and the next layer takes that partial sum in (the
port's ``layers.ExpertShare``). The weights' tree is the port's: llama's
with expert tables of the held share and the router scoring every
expert. The attention calls are llama's; the model FLOPs
count each token's share of the routed work that the held experts do.
"""
from __future__ import annotations

import dataclasses

import torch

from servebench.archs import llama
from servebench.archs.llama import decode_call, prefill_call

_TINY = {"name": "tiny-arctic", "num_hidden_layers": 2, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "intermediate_size": 32, "vocab_size": 512, "rope_theta": 10000.0,
         "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
         "torch_dtype": "float32", "hidden_act": "silu", "arch": "arctic",
         "num_local_experts": 8, "held_experts": 2,
         "held_expert_first": 0, "num_experts_per_tok": 2,
         "parallel_attn_mlp_res": True, "residual_mlp_ffn_dim": 64}
# configurations small enough for the CPU tests: the first share, a later one
TINY = [_TINY, dict(_TINY, name="tiny-arctic-last", held_expert_first=6)]


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the weights and the work counts need."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int                   # one expert's width
    vocab: int
    routed: int                 # experts the router scores
    held: int                   # experts the card holds
    first: int                  # global id of the first held expert
    top_k: int
    dense_residual_ff: int
    tied: bool = False
    dtype_bytes: int = 2


def shape(raw: dict) -> Shape:
    """``head_dim`` is hidden_size / heads where the config gives none; the
    dense residual MLP is ``residual_mlp_ffn_dim`` wide (llama's
    ``shape``)."""
    s = llama.shape(raw)
    return Shape(layers=s.layers, d_model=s.d_model, heads=s.heads,
                 kv_heads=s.kv_heads, head_dim=s.head_dim, d_ff=s.d_ff,
                 vocab=s.vocab, routed=s.experts, held=raw["held_experts"],
                 first=raw.get("held_expert_first", 0), top_k=s.top_k,
                 dense_residual_ff=s.dense_residual_ff, tied=s.tied)


def vocab(raw: dict) -> int:
    return raw["vocab_size"]


def _llama(s: Shape) -> llama.Shape:
    return llama.Shape(layers=s.layers, d_model=s.d_model, heads=s.heads,
                       kv_heads=s.kv_heads, head_dim=s.head_dim, d_ff=s.d_ff,
                       vocab=s.vocab, experts=s.held, top_k=s.top_k,
                       dense_residual_ff=s.dense_residual_ff, tied=s.tied,
                       dtype_bytes=s.dtype_bytes)


def layout(s: Shape, dtype=torch.bfloat16) -> dict:
    """llama's tree and scales with the held experts' tables, the router
    (f32) scoring all ``routed`` experts."""
    tree = llama.layout(_llama(s), dtype)
    tree["blocks"]["moe"]["router"] = ((s.layers, s.d_model, s.routed),
                                       torch.float32, s.d_model ** -0.5)
    return tree


def port_config(raw: dict, dtype):
    """The port's ``ExpertShare``: llama's ``ModelConfig`` with the held
    tables' count, the router's width and the share's first id."""
    from repro_torch.models.layers import ExpertShare
    base = llama.port_config(raw, dtype)
    s = shape(raw)
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    fields["num_experts"] = s.held
    return ExpertShare(**fields, routed_experts=s.routed,
                       first_expert=s.first)


def layer_params(s: Shape) -> float:
    """Weights a token multiplies by in one layer on this card: the
    attention's four projections, the router, the dense residual MLP, and
    of its top_k experts the share this card holds, top_k x held / routed
    of them (each token's expectation under routing spread evenly over the
    experts; a quarter of the top-2 at 32 of 128)."""
    attn = s.d_model * (s.heads + 2 * s.kv_heads) * s.head_dim \
        + s.heads * s.head_dim * s.d_model
    experts = s.top_k * s.held / s.routed * 3 * s.d_model * s.d_ff
    return float(attn + s.d_model * s.routed + experts
                 + 3 * s.d_model * s.dense_residual_ff)


def token_flops(s: Shape, context: float, logits: bool) -> float:
    """Model FLOPs of one token through every layer, attending over
    ``context`` keys in each, and through the unembedding if it yields a
    token."""
    per_layer = 2.0 * layer_params(s) + 4.0 * s.heads * s.head_dim * context
    return s.layers * per_layer + (2.0 * s.d_model * s.vocab if logits
                                   else 0.0)


def chunk_flops(s: Shape, start: int, take: int, final: bool) -> float:
    """Model FLOPs of a prefill chunk of ``take`` prompt tokens after
    ``start`` cached ones (llama's ``chunk_flops`` with this card's
    ``layer_params``)."""
    context = take * start + take * (take + 1) / 2
    per_layer = 2.0 * layer_params(s) * take \
        + 4.0 * s.heads * s.head_dim * context
    return s.layers * per_layer + (2.0 * s.d_model * s.vocab if final
                                   else 0.0)


def count(s: Shape, parts, lengths, table_cols: int) -> list:
    """An iteration's work, as llama's ``count``: one chunked-prefill call
    a bucket and layer, one paged-decode call a layer, then ``("step",
    model FLOPs, 0.0)`` with this card's ``layer_params``."""
    calls, groups = [], {}
    flops = 0.0
    for bucket, start, take, final in parts:
        groups.setdefault(bucket, []).append((start, take))
        flops += chunk_flops(s, start, take, final)
    for rows in groups.values():
        f, b = prefill_call(s, rows)
        calls += [("prefill", f, b)] * s.layers
    if lengths:
        flops += sum(token_flops(s, float(n), True) for n in lengths)
        f, b = decode_call(s, lengths, table_cols)
        calls += [("decode", f, b)] * s.layers
    calls.append(("step", flops, 0.0))
    return calls
