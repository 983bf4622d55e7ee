"""What a kernel op costs, and who is told.

Every call of a ``kernels.ops`` op, on any device, reports its work to the
listeners in ``LISTENERS`` (nothing is done when there are none): the
dense count that the JAX dry-run records for the same shapes, whose model
attends through XLA's ``_attn_block`` over the whole cache
(``repro/models/layers.py:286-300``) and runs the jnp WKV forms. A prefill
of Sq queries over an Sk-row cache is 4·B·Hq·Sq·Sk·D FLOPs, a decode over
a Sk-token table 4·B·Hq·Sk·D; the kernels do less (they skip key blocks
past the causal frontier or outside the window). WKV6: 2·B·H·D² a token
for a decode or a scan, and for the chunked form (T a multiple of 64,
chunks of C = 64) 2·B·H·(2·C·D² + 2·C²·D) a chunk. Bytes are the op's
inputs (for a decode, the K/V rows its table addresses) and its outputs,
once each. The fused pointwise passes count no FLOPs (the dry-run counts
dots only) and their bytes alike: for the cache write, the new rows. The
routed expert products count the dense dispatch the JAX reference runs:
every token through every held expert, 6·T·E·d·f, every table read.

A listener is any object with ``add_op(name, flops, nbytes, shapes)``;
``launch.hloanalysis.StepCost`` adds itself while it is on.
"""
from __future__ import annotations

LISTENERS: list = []         # the listeners on, innermost last


def report(name: str, q, kv, cost: tuple) -> None:
    """``cost`` = (FLOPs, bytes) of one call of op ``name``, to every
    listener, with its q and K/V shapes and dtypes."""
    shapes = (tuple(q.shape), tuple(kv.shape), str(q.dtype), str(kv.dtype))
    for listener in LISTENERS:
        listener.add_op(name, *cost, shapes)


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def paged_attention_cost(q, k_pages, block_tables) -> tuple:
    """(FLOPs, bytes) of a decode: 4·B·Hq·Sk·D over the Sk = P·ps tokens
    of the table's P pages, the K/V rows those pages hold read once."""
    b, hq, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    sk = block_tables.shape[1] * ps
    kv = 2.0 * b * sk * hkv * d * k_pages.element_size()
    return 4.0 * b * hq * sk * d, 2 * _nbytes(q) + kv + _nbytes(block_tables)


def chunked_prefill_cost(q, k_cache, v_cache) -> tuple:
    """(FLOPs, bytes) of a prefill chunk: 4·B·Hq·Sq·Sk·D over the whole
    Sk-row cache."""
    b, sq, hq, d = q.shape
    sk = k_cache.shape[1]
    return (4.0 * b * hq * sq * sk * d,
            2 * _nbytes(q) + _nbytes(k_cache, v_cache))


def wkv6_cost(r, k, v, w, u, s0, mode: str) -> tuple:
    """(FLOPs, bytes) of the WKV6 form the JAX model runs for these
    shapes: 2·B·H·D² a token (decode, scan), or the chunked form's
    products, 2·B·H·(2·C·D² + 2·C²·D) a chunk of C = 64; the bytes of the
    inputs and of the f32 output and final state."""
    b, t, h, d = r.shape
    if mode == "chunked" and t % 64 == 0 and t >= 64:
        c = 64
        flops = (t // c) * 2.0 * b * h * (2 * c * d * d + 2 * c * c * d)
    else:
        flops = 2.0 * b * h * d * d * t
    return flops, _nbytes(r, k, v, w, u, s0) + 4.0 * r.numel() \
        + 4.0 * s0.numel()


def pointwise_cost(reads, writes) -> tuple:
    """(0 FLOPs, bytes) of a fused pointwise pass: the tensors it reads and
    those it writes, once each (``None`` for an input not given)."""
    return 0.0, _nbytes(*(t for t in (*reads, *writes) if t is not None))


def moe_experts_cost(x, w_gate, w_up, w_down) -> tuple:
    """(FLOPs, bytes) of the dense dispatch over E held experts: 2·T·d·f
    for each of the three products of every (token, expert), the tables
    and the tokens in and out once each."""
    t, d = x.shape
    e, _, f = w_gate.shape
    return 6.0 * t * e * d * f, _nbytes(w_gate, w_up, w_down) + 2 * _nbytes(x)
