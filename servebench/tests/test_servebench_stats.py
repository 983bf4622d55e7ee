"""The end-to-end arithmetic: every attempted request counts, a failure
misses both limits and enters both tails."""
import numpy as np
import pytest

from servebench import stats


def served(**kw):
    base = dict(arrival=0.0, prompt=100, first_token=0.5, finish=2.0,
                decode_time=1.5, tokens=16, ttft_limit=1.0, tpot_limit=0.2)
    base.update(kw)
    return stats.Served(**base)


def test_finished_request_as_the_port_counts_it():
    s = served()
    assert s.ttft(9.0) == 0.5 and s.tpot(9.0) == pytest.approx(0.1)
    assert s.met(9.0) and not s.failed


def test_failed_request_misses_and_enters_the_tails():
    close = 10.0
    waiting = served(first_token=None, finish=None, decode_time=0.0,
                     tokens=0, arrival=4.0)
    started = served(first_token=5.0, finish=None, decode_time=0.0,
                     tokens=1, arrival=4.0)
    streaming = served(finish=None, decode_time=3.0, tokens=4)
    assert waiting.failed and not waiting.met(close)
    assert waiting.ttft(close) == 6.0 and waiting.tpot(close) == 6.0
    assert started.ttft(close) == 1.0 and started.tpot(close) == 5.0
    assert streaming.tpot(close) == 1.0 and not streaming.met(close)
    good = [served() for _ in range(8)]
    out = stats.summarize(good + [waiting, started], close, wall_s=2.0)
    assert out["attempted"] == 10 and out["failed"] == 2
    assert out["slo_attainment"] == 0.8
    assert out["ttft_p90_s"] == pytest.approx(
        np.percentile([0.5] * 8 + [6.0, 1.0], 90))
    assert out["tpot_p90_s"] > 1.0
    assert out["tokens_per_card_s"] == (16 * 8 + 1) / 2.0


def test_percentile_is_the_ports():
    from repro_torch.core.metrics import percentile
    xs = list(np.random.default_rng(1).random(37))
    assert stats.percentile(xs, 90) == percentile(xs, 90)


def test_empty_window_has_no_metrics():
    with pytest.raises(ValueError):
        stats.summarize([], 1.0, 1.0)
