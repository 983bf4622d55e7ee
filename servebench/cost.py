"""The yardstick's peaks: the card's, and the least time a call can take.

Frozen here so that no change to the program moves it. Each architecture
counts its own calls' operations and bytes and its model FLOPs
(``count`` in ``servebench/archs/<name>.py``); the readers hold them
against these peaks.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: dense bf16 tensor-core peak and HBM3
# bandwidth, at the card's full 700 W.
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time a call can take on the card: the larger of its
    operations at peak and its bytes at peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
