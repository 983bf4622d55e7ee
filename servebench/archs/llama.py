"""The Llama block, dense or with Arctic's MoE beside a dense residual MLP:
what the harness needs to run a configuration of it (``servebench/archs``).

Sizes from the published ``config.json`` keys. The weights' tree is the
port's (``models/transformer.py``'s layout). The work counts are the
yardstick's: the attention kernels' operations and bytes and the model
FLOPs of a token, counted causally and over real rows only. A prefill
query at position p needs keys 0..p, a decode row of length n reads its n
keys; the executor's padding, repeated rows and idle slots are left out,
so a change that removes them shows as a gain. Each input byte is read
once and each output byte written once. The port keeps its own counts in
``kernels/cost.py``, which price a call densely (every query against every
row of the cache), as the JAX dry-run does.
"""
from __future__ import annotations

import dataclasses

import torch

_DENSE = {"name": "tiny-dense", "num_hidden_layers": 2, "hidden_size": 64,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "intermediate_size": 128, "vocab_size": 512,
          "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
          "tie_word_embeddings": False, "torch_dtype": "float32"}
# configurations small enough for the CPU tests: dense, MoE, tied
TINY = [_DENSE,
        dict(_DENSE, name="tiny-moe", num_local_experts=8,
             num_experts_per_tok=2, parallel_attn_mlp_res=True,
             residual_mlp_ffn_dim=64, rms_norm_eps=1e-5),
        dict(_DENSE, name="tiny-tied", tie_word_embeddings=True)]


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the weights and the work counts need."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    dense_residual_ff: int = 0
    tied: bool = True
    dtype_bytes: int = 2


def shape(raw: dict) -> Shape:
    """``head_dim`` is hidden_size / heads where the config gives none.
    The dense residual MLP's width beside a MoE layer
    (``parallel_attn_mlp_res``) is its own key: Arctic's
    ``modeling_arctic.py`` builds it ``hidden_size`` wide, not
    ``intermediate_size``."""
    return Shape(
        layers=raw["num_hidden_layers"], d_model=raw["hidden_size"],
        heads=raw["num_attention_heads"],
        kv_heads=raw["num_key_value_heads"],
        head_dim=raw.get("head_dim", raw["hidden_size"]
                         // raw["num_attention_heads"]),
        d_ff=raw["intermediate_size"], vocab=raw["vocab_size"],
        experts=raw.get("num_local_experts", 0),
        top_k=raw.get("num_experts_per_tok", 0),
        dense_residual_ff=raw["residual_mlp_ffn_dim"]
        if raw.get("parallel_attn_mlp_res") else 0,
        tied=bool(raw.get("tie_word_embeddings", False)))


def vocab(raw: dict) -> int:
    return raw["vocab_size"]


def layout(shape: Shape, dtype=torch.bfloat16) -> dict:
    """Every leaf's (shape, dtype, std) in the port's tree; std 0 is a
    zero-filled leaf. Scales: N(0, 1/fan_in) for every projection (the
    fan-in of a stacked expert table is d_model, not the expert count),
    N(0, 0.02^2) for the embeddings, zeros for the norm weights (the
    port's ``1 + weight`` form); the router in f32, as the port keeps it."""
    L, d, h, kv, hd = (shape.layers, shape.d_model, shape.heads,
                       shape.kv_heads, shape.head_dim)
    ff = shape.dense_residual_ff if shape.experts else shape.d_ff
    f32 = torch.float32
    blocks = {
        "norm_attn": {"scale": ((L, d), dtype, 0.0)},
        "attn": {"wq": ((L, d, h, hd), dtype, d ** -0.5),
                 "wk": ((L, d, kv, hd), dtype, d ** -0.5),
                 "wv": ((L, d, kv, hd), dtype, d ** -0.5),
                 "wo": ((L, h, hd, d), dtype, (h * hd) ** -0.5)},
        "norm_mlp": {"scale": ((L, d), dtype, 0.0)},
    }
    if ff:
        blocks["mlp"] = {"w_gate": ((L, d, ff), dtype, d ** -0.5),
                         "w_up": ((L, d, ff), dtype, d ** -0.5),
                         "w_down": ((L, ff, d), dtype, ff ** -0.5)}
    if shape.experts:
        e, f = shape.experts, shape.d_ff
        blocks["moe"] = {"router": ((L, d, e), f32, d ** -0.5),
                         "w_gate": ((L, e, d, f), dtype, d ** -0.5),
                         "w_up": ((L, e, d, f), dtype, d ** -0.5),
                         "w_down": ((L, e, f, d), dtype, f ** -0.5)}
    embed = {"table": ((shape.vocab, d), dtype, 0.02)}
    if not shape.tied:
        embed["unembed"] = ((shape.vocab, d), dtype, 0.02)
    return {"embed": embed, "blocks": blocks,
            "final_norm": {"scale": ((d,), dtype, 0.0)}}


def port_config(raw: dict, dtype):
    """The port's ``ModelConfig`` of this configuration."""
    from repro_torch.models.layers import ModelConfig
    if raw.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{raw['name']}: the port's gated MLP here is "
                         "SwiGLU (hidden_act silu)")
    s = shape(raw)
    return ModelConfig(
        name=raw["name"], family="moe" if s.experts else "dense",
        num_layers=s.layers, d_model=s.d_model, num_heads=s.heads,
        num_kv_heads=s.kv_heads, head_dim=s.head_dim, d_ff=s.d_ff,
        vocab_size=s.vocab, rope_theta=float(raw["rope_theta"]),
        norm_eps=float(raw["rms_norm_eps"]),
        tie_embeddings=s.tied, num_experts=s.experts, top_k=s.top_k,
        moe_dense_residual_ff=s.dense_residual_ff, dtype=dtype)


def count(s: Shape, parts, lengths, table_cols: int) -> list:
    """An iteration's work: for the prefill parts ``(bucket, start, take,
    final)``, one chunked-prefill call a bucket and layer (as the executor
    groups them); for the decoding rows' ``lengths`` (the new key
    included), one paged-decode call a layer over a block table of
    ``table_cols`` columns; then ``("step", model FLOPs, 0.0)``."""
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


def prefill_call(s: Shape, parts) -> tuple[float, float]:
    """(FLOPs, bytes) of the work one chunked-prefill kernel call of one
    layer has to do: for each part ``(start, take)``, the queries at
    positions start .. start + take - 1, each attending causally. Bytes:
    the parts' q and output, and each part's K and V up to its last query.
    What the executor adds (a row padded to its bucket, rows repeated to a
    power of two) is not work the inputs need, and is not counted."""
    e = s.dtype_bytes
    flops = nbytes = 0.0
    for st, take in parts:
        keys = take * st + take * (take + 1) / 2         # sum over queries
        flops += 4.0 * s.heads * s.head_dim * keys
        nbytes += 2.0 * take * s.heads * s.head_dim * e            # q, out
        nbytes += 2.0 * (st + take) * s.kv_heads * s.head_dim * e  # K, V
    return flops, nbytes


def decode_call(s: Shape, lengths, table_cols: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the work one paged-decode kernel call of one layer
    has to do for the rows that decode: row b holds ``lengths[b]`` keys
    (the new one included); its q and output, its K and V rows, its block
    table row and length. Slots that do not decode in the call are not
    counted."""
    e = s.dtype_bytes
    keys = float(sum(lengths))
    rows = len(lengths)
    flops = 4.0 * s.heads * s.head_dim * keys
    nbytes = (2.0 * rows * s.heads * s.head_dim * e
              + 2.0 * keys * s.kv_heads * s.head_dim * e
              + 4.0 * rows * (table_cols + 1))
    return flops, nbytes


def layer_params(s: Shape) -> float:
    """Weights a token multiplies by in one layer: the attention's four
    projections and the MLP, or for a MoE layer the router, its top-k
    experts and the dense residual MLP."""
    attn = s.d_model * (s.heads + 2 * s.kv_heads) * s.head_dim \
        + s.heads * s.head_dim * s.d_model
    if s.experts:
        mlp = s.d_model * s.experts + s.top_k * 3 * s.d_model * s.d_ff \
            + 3 * s.d_model * s.dense_residual_ff
    else:
        mlp = 3 * s.d_model * s.d_ff
    return float(attn + mlp)


def token_flops(s: Shape, context: float, logits: bool) -> float:
    """Model FLOPs of one token through every layer, attending over
    ``context`` keys in each, and through the unembedding if it yields a
    token."""
    per_layer = 2.0 * layer_params(s) + 4.0 * s.heads * s.head_dim * context
    return s.layers * per_layer + (2.0 * s.d_model * s.vocab if logits
                                   else 0.0)


def chunk_flops(s: Shape, start: int, take: int, final: bool) -> float:
    """Model FLOPs of a prefill chunk of ``take`` prompt tokens after
    ``start`` cached ones: the causal sum of each token's context, and the
    unembedding once if it finishes the prompt."""
    context = take * start + take * (take + 1) / 2
    per_layer = 2.0 * layer_params(s) * take \
        + 4.0 * s.heads * s.head_dim * context
    return s.layers * per_layer + (2.0 * s.d_model * s.vocab if final
                                   else 0.0)
