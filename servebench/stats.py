"""The end-to-end serving metrics, over every request a window offered.

The arithmetic of the port's ``core/metrics.py`` and ``Request.ttft`` /
``Request.tpot`` (paper Eq. 1-3), frozen here, with one change: the port's
``ServeMetrics`` takes its tails over finished requests only, so a request
that never finishes drops out of them. Here every attempted request
counts. One that has not finished when the window closes has failed: it
misses both limits, and enters

* the TTFT tail at its first token's time if it had one, else at the wait
  it had reached when the window closed (``close - arrival``);
* the TPOT tail at its time per output token so far: decode seconds over
  the tokens after the first, or, with no second token yet, the seconds
  since its first token (since arrival, with no first token either).

All times are on the scheduler's clock.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Served:
    """What a window did with one attempted request."""
    arrival: float
    prompt: int
    first_token: Optional[float]       # scheduler time, None if not yet
    finish: Optional[float]            # scheduler time, None if failed
    decode_time: float                 # seconds of decode iterations
    tokens: int                        # output tokens streamed so far
    ttft_limit: float
    tpot_limit: float

    @property
    def failed(self) -> bool:
        return self.finish is None

    def ttft(self, close: float) -> float:
        if self.first_token is not None:
            return self.first_token - self.arrival
        return close - self.arrival

    def tpot(self, close: float) -> float:
        if self.tokens > 1:
            return self.decode_time / (self.tokens - 1)
        if self.finish is not None:
            return 0.0                 # one output token: no gap to time
        start = self.first_token if self.first_token is not None \
            else self.arrival
        return close - start

    def met(self, close: float) -> bool:
        return (not self.failed and self.ttft(close) <= self.ttft_limit
                and self.tpot(close) <= self.tpot_limit)


def percentile(xs: Sequence[float], p: float) -> float:
    """The port's ``core.metrics.percentile``: numpy's linear one."""
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


def summarize(served: Sequence[Served], close: float, wall_s: float) -> dict:
    """The end-to-end metrics of one window (``close``: the scheduler's
    time when it closed; ``wall_s``: its wall seconds)."""
    n = len(served)
    if n == 0 or wall_s <= 0:
        raise ValueError("a window with no request offered has no metrics")
    ttfts = [s.ttft(close) for s in served]
    tpots = [s.tpot(close) for s in served]
    met = sum(s.met(close) for s in served)
    tokens = sum(s.tokens for s in served)
    out = {
        "attempted": n,
        "failed": sum(s.failed for s in served),
        "ttft_p90_s": percentile(ttfts, 90),
        "tpot_p90_s": percentile(tpots, 90),
        "slo_attainment": met / n,
        "tokens_per_card_s": tokens / wall_s,
        "output_tokens": tokens,
    }
    if not all(math.isfinite(v) for v in out.values()):
        raise ValueError(f"non-finite metric in {out}")
    return out
