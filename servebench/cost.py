"""The yardstick's arithmetic: the card's peaks, the attention kernels'
operations and bytes, and the model FLOPs of a token.

Frozen here so that no change to the program moves it. The port keeps its
own counts in ``kernels/cost.py``, which price a call densely, as the JAX
dry-run does (every query against every row of the cache). A roofline
share has to count the work the requests need (its bound), so these count
causally and only real rows: a prefill query at position p needs keys
0..p, a decode row of length n reads its n keys; the executor's padding,
repeated rows and idle slots are left out, so a change that removes them
shows as a gain. Each input byte is read once and each output byte
written once.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 80 GB data sheet: dense bf16 tensor-core peak and HBM3
# bandwidth, at the card's full 700 W.
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the arithmetic needs, from a configuration file."""
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


def bound_s(flops: float, nbytes: float) -> float:
    """The least time a call can take on the card: the larger of its
    operations at peak and its bytes at peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


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
