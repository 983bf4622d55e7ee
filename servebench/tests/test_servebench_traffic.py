"""The traffic generator: deterministic from the seed, drawing the
distributions its mix files state, i.i.d. within a seed's stream, and the
same requests in another order from seed to seed."""
import math
from statistics import NormalDist

import numpy as np
import pytest

from servebench import traffic

SEED = 2**31 + 12345


def _blocks(arrivals, mix):
    size = mix.arrivals["block_s"]
    out: dict = {}
    for a in arrivals:
        out.setdefault(int(a.time // size), []).append((a.prompt, a.output))
    return {b: sorted(v) for b, v in out.items()}


def test_same_seed_same_stream():
    mix = traffic.Mix.load("mooncake")
    assert traffic.generate(mix, SEED, 3.0, 90) == \
        traffic.generate(mix, SEED, 3.0, 90)


def test_seeds_offer_the_same_requests_in_another_order():
    mix = traffic.Mix.load("mooncake")
    a = traffic.generate(mix, SEED, 3.0, 90)
    c = traffic.generate(mix, 77, 3.0, 90)
    assert len({x.rid for x in a} | {x.rid for x in c}) == len(a) + len(c)
    assert [x.prompt for x in a] != [x.prompt for x in c]
    assert [x.time for x in a] != [x.time for x in c]
    # each block holds the same sizes, whatever the seed
    assert _blocks(a, mix) == _blocks(c, mix)


def test_a_higher_rate_offers_more_of_the_same_draws():
    mix = traffic.Mix.load("short")
    lo = traffic.generate(mix, 5, 4.0, 30)
    hi = traffic.generate(mix, 5, 8.0, 30)
    assert 1.7 < len(hi) / len(lo) < 2.3


@pytest.mark.parametrize("name", ["mooncake", "short"])
def test_lengths_follow_the_mix(name):
    mix = traffic.Mix.load(name)
    pm, om = mix.prompt, mix.output
    p, o = traffic.sample_lengths(np.random.default_rng(3), 20000, pm, om)
    assert p.min() >= pm["min"] and p.max() <= pm["max"]
    assert o.min() >= om["min"] and o.max() <= om["max"]
    nd = NormalDist()
    for q in (0.25, 0.5, 0.75):
        want = om["median"] * math.exp(om["sigma"] * nd.inv_cdf(q))
        assert abs(np.quantile(o, q) - want) <= 0.03 * want + 1
    f = pm["tail_frac"]
    for q in (0.1, 0.3, 0.5, 0.7):
        x = np.quantile(p, q)
        cdf = (1 - f) * nd.cdf(math.log(x / pm["body_median"])
                               / pm["body_sigma"])
        if f:
            cdf += f * nd.cdf(math.log(x / pm["tail_median"])
                              / pm["tail_sigma"])
        assert abs(cdf - q) < 0.02


def _mean(median, sigma):
    return median * math.exp(sigma ** 2 / 2)


def test_mixes_hold_their_sources_means():
    """Before the cuts, each mix's lognormals have the means its source
    publishes: Mooncake's trace 7,590 prompt and 182 output tokens (its
    prompts cut by 1/12), LMSYS-Chat-1M's 69.5 and 214.5."""
    m = traffic.Mix.load("mooncake")
    p, f = m.prompt, m.prompt["tail_frac"]
    prompt = (1 - f) * _mean(p["body_median"], p["body_sigma"]) \
        + f * _mean(p["tail_median"], p["tail_sigma"])
    assert prompt * 12 == pytest.approx(7590, rel=1e-3)
    assert _mean(m.output["median"], m.output["sigma"]) == \
        pytest.approx(182, rel=1e-3)
    s = traffic.Mix.load("short")
    assert _mean(s.prompt["body_median"], s.prompt["body_sigma"]) == \
        pytest.approx(69.5, rel=1e-3)
    assert _mean(s.output["median"], s.output["sigma"]) == \
        pytest.approx(214.5, rel=1e-3)


@pytest.mark.parametrize("name", ["mooncake", "short"])
def test_arrivals_keep_the_mean_rate_and_burst(name):
    mix = traffic.Mix.load(name)
    t = np.array([a.time for a in traffic.generate(mix, 9, 20.0, 3000)])
    assert np.all(np.diff(t) >= 0)
    assert abs(len(t) / 3000 - 20.0) < 20.0 * 0.08
    # Gamma(2) windows spread the per-window counts far more than Gamma(50)
    counts = np.bincount((t // mix.arrivals["window_s"]).astype(int))
    cv = counts.std() / counts.mean()
    assert (cv > 0.5) if mix.arrivals["shape"] == 2.0 else (cv < 0.4)


def test_gaps_cluster_as_independent_draws_do():
    """Near-Poisson arrivals: two short gaps in a row come as often as two
    independent exponential draws make them (0.3 x 0.3), not never."""
    mix = traffic.Mix.load("short")
    t = np.array([a.time for a in traffic.generate(mix, 4, 20.0, 3000)])
    g = np.diff(t)
    short = g < np.quantile(g, 0.3)
    both = np.mean(short[1:] & short[:-1])
    assert 0.07 < both < 0.11
