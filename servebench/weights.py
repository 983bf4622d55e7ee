"""The benchmark's weights: drawn on the device from the run's seed, into
an architecture's tree (its ``layout``: ``servebench/archs/<name>.py``),
in the types they are served in.

One ``torch.Generator`` on the device fills each tensor in place, in the
tree's order, in pieces of at most ``PIECE`` elements (a few calls per
tensor). Both the port (``ClusterRealExecutors(params=...)``) and the
reference read these same tensors; the reference casts them to f32
itself, one matrix at a time.
"""
from __future__ import annotations

import sys

import torch

PIECE = 1 << 30


def _fill(t: torch.Tensor, gen: torch.Generator, std: float) -> torch.Tensor:
    flat = t.view(-1)
    for lo in range(0, flat.numel(), PIECE):
        flat[lo:lo + PIECE].normal_(0.0, std, generator=gen)
    return t


def _normal(shape, std, dtype, gen):
    return _fill(torch.empty(shape, dtype=dtype, device=gen.device), gen, std)


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


def _leaves(params):
    for v in params.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def _tree(tree, dtype) -> dict:
    """``tree`` itself, or for a configuration's shape (``Config.shape()``)
    the layout of the architecture whose module defines the shape's class,
    in ``dtype``."""
    if isinstance(tree, dict):
        return tree
    arch = sys.modules[type(tree).__module__]
    return arch.layout(tree, dtype or torch.bfloat16)


def make(tree, seed: int, device, dtype=None) -> dict:
    """The weights of ``seed`` on ``device``: every leaf of ``tree``
    (``Config.layout()``), or of a shape's layout in ``dtype``."""
    return _build(_tree(tree, dtype), generator(seed, device))


def redraw(params: dict, tree, seed: int) -> None:
    """Draw ``seed``'s weights into ``params`` in place (the same storage,
    so graphs captured over it stay valid): equal to ``make``'s."""
    dev = next(_leaves(params)).device
    _refill(params, _tree(tree, None), generator(seed, dev))
