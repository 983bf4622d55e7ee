"""The benchmark's weights: drawn on the device from the run's seed, in the
port's parameter tree (``models/transformer.py``'s layout), in the types
they are served in.

One ``torch.Generator`` on the device fills each stacked tensor in place,
in pieces of at most ``PIECE`` elements (a few calls per tensor). Both the
port (``ClusterRealExecutors(params=...)``) and the reference read these
same tensors; the reference casts them to f32 itself, one matrix at a
time. Scales: N(0, 1/fan_in) for every projection (the fan-in of a stacked
expert table is d_model, not the expert count), N(0, 0.02^2) for the
embeddings, zeros for the norm weights (the port's ``1 + weight`` form).
"""
from __future__ import annotations

import torch

PIECE = 1 << 30


def _fill(t: torch.Tensor, gen: torch.Generator, std: float) -> torch.Tensor:
    flat = t.view(-1)
    for lo in range(0, flat.numel(), PIECE):
        flat[lo:lo + PIECE].normal_(0.0, std, generator=gen)
    return t


def _normal(shape, std, dtype, gen):
    return _fill(torch.empty(shape, dtype=dtype, device=gen.device), gen, std)


def layout(shape, dtype=torch.bfloat16) -> dict:
    """Every leaf's (shape, dtype, std) in the port's tree; std 0 is a
    zero-filled leaf."""
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


def _build(tree, gen):
    if isinstance(tree, dict):
        return {k: _build(v, gen) for k, v in tree.items()}
    shp, dtype, std = tree
    if std == 0.0:
        return torch.zeros(shp, dtype=dtype, device=gen.device)
    return _normal(shp, std, dtype, gen)


def _refill(params, tree, gen):
    for k, v in tree.items():
        if isinstance(v, dict):
            _refill(params[k], v, gen)
        elif v[2]:
            _fill(params[k], gen, v[2])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def make(shape, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of ``seed`` on ``device`` (``dtype``: the CPU tests'
    f32 models)."""
    return _build(layout(shape, dtype), generator(seed, device))


def redraw(params: dict, shape, seed: int) -> None:
    """Draw ``seed``'s weights into ``params`` in place (the same storage,
    so graphs captured over it stay valid): equal to ``make``'s."""
    dev = next(iter(params["embed"].values())).device
    _refill(params, layout(shape), generator(seed, dev))
