"""Request-length profiles.

The Mooncake trace (paper §V-A) is not packaged offline, so we synthesise
length marginals matching the paper's characterisation (Fig. 3) and add
profiles for the workload families the paper's single trace cannot cover:

* ``MOONCAKE``  — long-tail prefills (lognormal body + heavy lognormal
  tail), short low-variance outputs;
* ``STEADY``    — the same shape with the tail and burstiness damped;
* ``LONGCTX``   — tail-heavy prefills: half the traffic is long-context
  (RAG / document QA), the regime where prefill head-of-line blocking
  dominates;
* ``AGENTIC``   — the inversion: short prompts, long generations (agents,
  chain-of-thought, code synthesis) — decode-capacity bound.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceProfile:
    name: str = "mooncake-like"
    # input-length mixture (lognormal body + tail)
    body_median: float = 2048.0
    body_sigma: float = 1.1
    tail_median: float = 16384.0
    tail_sigma: float = 0.7
    tail_frac: float = 0.15
    min_input: int = 16
    max_input: int = 32768      # Mooncake-like long-context cap: the tail
                                # service time stays within ~1x of the TTFT
                                # SLO (as in the paper's A100 setup), so
                                # head-of-line effects degrade rather than
                                # structurally break attainment
    # output lengths
    out_median: float = 256.0
    out_sigma: float = 0.7
    min_output: int = 2
    max_output: int = 2048
    # burstiness: per-window Gamma(shape k) rate modulation; k->inf = Poisson
    burst_window: float = 10.0      # seconds
    burst_shape: float = 2.0
    # shared system prompts: requests whose prompt exceeds ``prefix_tokens``
    # carry one of ``shared_prefixes`` prefix identities (uniformly drawn
    # from a dedicated RNG substream, so tagging never perturbs the
    # length/arrival streams). 0 = no sharing; the tags are inert unless a
    # worker-side prefix cache is armed.
    shared_prefixes: int = 0
    prefix_tokens: int = 0


MOONCAKE = TraceProfile(shared_prefixes=8, prefix_tokens=512)
STEADY = TraceProfile(name="steady", tail_frac=0.05, burst_shape=50.0)
LONGCTX = TraceProfile(
    name="longctx", tail_frac=0.45, tail_median=24576.0, tail_sigma=0.5,
    body_median=4096.0, out_median=192.0)
AGENTIC = TraceProfile(
    name="agentic", body_median=512.0, body_sigma=0.8, tail_frac=0.02,
    tail_median=4096.0, out_median=1024.0, out_sigma=0.9,
    min_output=64, max_output=4096,
    # agents re-enter with the same system prompt + tool schema: few
    # identities, high re-use — the prefix-cache sweet spot
    shared_prefixes=4, prefix_tokens=256)


def sample_lengths(rng: np.random.Generator, n: int,
                   prof: TraceProfile) -> tuple[np.ndarray, np.ndarray]:
    tail = rng.random(n) < prof.tail_frac
    body = rng.lognormal(math.log(prof.body_median), prof.body_sigma, n)
    tl = rng.lognormal(math.log(prof.tail_median), prof.tail_sigma, n)
    inputs = np.where(tail, tl, body)
    inputs = np.clip(inputs, prof.min_input, prof.max_input).astype(int)
    outputs = rng.lognormal(math.log(prof.out_median), prof.out_sigma, n)
    outputs = np.clip(outputs, prof.min_output, prof.max_output).astype(int)
    return inputs, outputs
