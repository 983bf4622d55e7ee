"""The benchmark's one traffic generator: open-loop arrivals with lengths.

A mix (``servebench/traffic/<name>.json``) gives the distributions, drawn
as the port's samplers draw them (``workload/profiles.py::sample_lengths``
copied; ``workload/arrivals.py::GammaPoisson``'s process), frozen here so
that no change to the program moves the yardstick:

* prompt tokens: a lognormal body (``body_median``, ``body_sigma``) and,
  with probability ``tail_frac``, a lognormal tail (``tail_median``,
  ``tail_sigma``), clipped to [``min``, ``max``];
* output tokens: lognormal (``median``, ``sigma``), clipped;
* arrivals: a Gamma-modulated Poisson process. Window j of ``window_s``
  seconds has rate ``rate * g_j``, g_j ~ Gamma(``shape``, 1 / ``shape``)
  (mean 1), independent; inside it, a Poisson process, drawn as unit
  exponential gaps in the integrated rate.

Every seed offers the same requests in another order. The levels, the
gaps and the lengths are i.i.d. draws from three streams of
``np.random.default_rng`` keyed by the mix's ``draw_seed``. The run's seed
permutes the levels among the windows of each block of ``block_s``
seconds, and the lengths among the requests that arrive in that block. A
block's integrated rate is the same in every order, so it holds the same
requests whatever the seed: a seed moves where the bursts and the long
requests fall, not how many there are. A block of about the offered
horizon keeps the offered work the same from seed to seed. Gaps and
lengths are drawn in fixed chunks, so a higher rate packs the same points
closer and a request keeps its lengths. The seed also names the requests
(``rid``), from which the port draws each prompt's token ids.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    prompt: dict
    output: dict
    arrivals: dict
    draw_seed: int = 0

    @classmethod
    def load(cls, name: str) -> "Mix":
        data = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
        return cls(name=data["name"], prompt=data["prompt"],
                   output=data["output"], arrivals=data["arrivals"],
                   draw_seed=int(data["draw_seed"]))


@dataclasses.dataclass(frozen=True)
class Arrival:
    rid: int
    time: float          # seconds on the scheduler's clock
    prompt: int          # prompt tokens
    output: int          # output tokens, the first included


def sample_lengths(rng: np.random.Generator, n: int, p: dict,
                   o: dict) -> tuple[np.ndarray, np.ndarray]:
    """``workload/profiles.py::sample_lengths``, over a mix's keys."""
    tail = rng.random(n) < p["tail_frac"]
    body = rng.lognormal(math.log(p["body_median"]), p["body_sigma"], n)
    tl = rng.lognormal(math.log(p["tail_median"]), p["tail_sigma"], n)
    inputs = np.where(tail, tl, body)
    inputs = np.clip(inputs, p["min"], p["max"]).astype(int)
    outputs = rng.lognormal(math.log(o["median"]), o["sigma"], n)
    outputs = np.clip(outputs, o["min"], o["max"]).astype(int)
    return inputs, outputs


def _unit_poisson(rng: np.random.Generator, total: float) -> np.ndarray:
    """The points of a unit-rate Poisson process in [0, total)."""
    points, last = [], 0.0
    while last < total:
        chunk = last + np.cumsum(rng.exponential(1.0, CHUNK))
        points.append(chunk)
        last = float(chunk[-1])
    points = np.concatenate(points)
    return points[points < total]


def rid_base(seed: int) -> int:
    """The first request id of a seed's stream: the seed's own range, so
    that prompts differ from seed to seed (the port seeds each prompt's
    token ids with the request id)."""
    return (seed % (1 << 31)) * (1 << 20)


def generate(mix: Mix, seed: int, rate: float,
             horizon: float) -> list[Arrival]:
    """The seed's requests over the first ``horizon`` seconds (whole
    blocks), in arrival order, at a mean of ``rate`` requests a second."""
    a = mix.arrivals
    window, shape = float(a["window_s"]), float(a["shape"])
    per_block = max(1, round(float(a["block_s"]) / window))
    blocks = max(1, math.ceil(horizon / (window * per_block)))
    levels_rng, gaps_rng, lengths_rng = (
        np.random.default_rng([mix.draw_seed, k]) for k in range(3))
    order = np.random.default_rng(seed)
    levels = levels_rng.gamma(shape, 1.0 / shape, (blocks, per_block))
    levels = np.concatenate([row[order.permutation(per_block)]
                             for row in levels])
    edges = np.concatenate([[0.0], np.cumsum(rate * window * levels)])
    points = _unit_poisson(gaps_rng, float(edges[-1]))
    j = np.searchsorted(edges, points, side="right") - 1
    times = j * window + (points - edges[j]) / (rate * levels[j])
    n = len(points)
    drawn = [sample_lengths(lengths_rng, CHUNK, mix.prompt, mix.output)
             for _ in range(-(-n // CHUNK))]
    prompts = np.concatenate([p for p, _ in drawn])[:n]
    outputs = np.concatenate([o for _, o in drawn])[:n]
    block = j // per_block
    for b in range(blocks):
        idx = np.flatnonzero(block == b)
        perm = idx[order.permutation(len(idx))]
        prompts[idx], outputs[idx] = prompts[perm], outputs[perm]
    base = rid_base(seed)
    return [Arrival(base + i, float(times[i]), int(prompts[i]),
                    int(outputs[i])) for i in range(n)]
