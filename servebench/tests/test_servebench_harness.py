"""A run's whole path on the CPU at tiny widths (the look for a card
skipped): the window, the counters, and ``correct``, which a fault in the
timed path has to turn false."""
import numpy as np
import pytest

from servebench import check, run, serve, traffic, weights
from tiny import DENSE, MOE, cell

SEED = 2**31 + 77


def _run(c, seconds=5.0):
    return run.run_cell(c, SEED, seconds, False, "cpu", {})


@pytest.mark.parametrize("config", [DENSE, MOE], ids=["dense", "moe"])
def test_sound_run_is_correct(config):
    out = _run(cell(config))
    assert run.checks_pass(out["checks"])
    s = out["summary"]
    assert s["attempted"] > 5 and s["output_tokens"] > 0
    assert out["checks"]["requests_compared"][0] >= 2
    assert out["tokens_compared"] >= 40


def test_token_altered_where_produced_is_not_correct(monkeypatch):
    from repro_torch.serving import executor as ex
    real = ex._to_host

    def altered(t):
        out = real(t)
        out[0] = (out[0] + 1) % 512
        return out
    monkeypatch.setattr(ex, "_to_host", altered)
    out = _run(cell())
    assert not run.checks_pass(out["checks"])
    assert out["checks"]["widest_gap"][0] > 10 * 1e-3


def test_step_that_leaves_the_cache_unchanged_is_not_correct(monkeypatch):
    from repro_torch.models import layers
    real = layers._cache_write

    def dropped(cache, new, pos):
        if new.shape[1] > 1:
            real(cache, new, pos)        # prefill keeps its writes
    monkeypatch.setattr(layers, "_cache_write", dropped)
    out = _run(cell())
    assert not run.checks_pass(out["checks"])


def test_half_the_decode_batch_left_out_is_not_correct(monkeypatch):
    """A decode step whose second half of rows is never computed (their
    logits left at zero): those requests' tokens are wrong."""
    from repro_torch.models import transformer
    real = transformer.decode

    def halved(params, cache, tokens, lengths, cfg, ep=None):
        logits, cache = real(params, cache, tokens, lengths, cfg, ep=ep)
        logits[logits.shape[0] // 2:] = 0
        return logits, cache
    monkeypatch.setattr(transformer, "decode", halved)
    out = _run(cell())
    assert not run.checks_pass(out["checks"])


def test_window_asks_only_for_warmed_steps(monkeypatch):
    c = cell(slots=4)
    asked = set()
    from repro_torch.serving.executor import ExecutorKernels
    real = ExecutorKernels.step

    def spy(self, params, cache, key, flat):
        asked.add(key)
        return real(self, params, cache, key, flat)
    monkeypatch.setattr(ExecutorKernels, "step", spy)
    params = weights.make(c.config.layout(), 1, "cpu")
    port = serve.Port(c, params, "cpu")
    warmed = set(port.keys())
    asked.clear()
    arrivals = traffic.generate(c.mix, 1, 6.0, 40)
    serve.run_window(port, c, arrivals, 5.0)
    assert asked and asked <= warmed


def test_recorded_work_is_the_requests_own():
    """With ``record``, the prefill calls count each prompt's causal
    queries once and the decode calls one row a token decoded over its
    keys, however the executor pads, groups or repeats rows; each
    iteration's model FLOPs are counted once."""
    c = cell()
    s = c.config.shape()
    params = weights.make(c.config.layout(), 2, "cpu")
    port = serve.Port(c, params, "cpu")
    arrivals = traffic.generate(c.mix, 2, 2.0, 4.0)
    win = serve.run_window(port, c, arrivals, 60.0, record=True)
    reqs = win.requests
    assert win.drained and len(reqs) == len(arrivals)
    assert all(r.prior_tokens == 0 for r in reqs)
    calls = win.recorder.calls
    per_key = 4.0 * s.heads * s.head_dim
    got = sum(f for k, f, _ in calls if k == "prefill")
    assert got == pytest.approx(s.layers * per_key * sum(
        r.prompt_len * (r.prompt_len + 1) / 2 for r in reqs))
    got = sum(f for k, f, _ in calls if k == "decode")
    assert got == pytest.approx(s.layers * per_key * sum(
        sum(r.prompt_len + j for j in range(1, r.output_len))
        for r in reqs))
    steps = [f for k, f, _ in calls if k == "step"]
    assert len(steps) == win.recorder.iterations and min(steps) > 0


def test_prefill_keys_by_hand():
    # buckets 32, 64, 128; prompts to 100; 4 slots; 100 tokens a budget:
    # 32 takes any part (4 rows), 64 parts of 33+ (3 -> 4 rows), 128 parts
    # of 65+ (1 row)
    keys = serve.prefill_keys((32, 64, 128), 100, 4, 100)
    assert keys == [("prefill", 32, 1), ("prefill", 32, 2),
                    ("prefill", 32, 4), ("prefill", 64, 1),
                    ("prefill", 64, 2), ("prefill", 64, 4),
                    ("prefill", 128, 1)]


def test_control_reads_far_above_the_port_in_bf16():
    """The e4m3 control against the port at a tiny bf16 size: the control's
    widest gap is several times the port's (the dense model: at these
    widths a MoE's bf16 routes flip as often as its e4m3 ones do)."""
    c = cell(DENSE, "bfloat16")
    params = weights.make(c.config.layout(), 9, "cpu")
    port = serve.Port(c, params, "cpu")
    port.warm()
    arrivals = traffic.generate(c.mix, 9, c.rate, 40)
    win = serve.run_window(port, c, arrivals, 5.0)
    items = check.sample(win, port, c, 9)
    got = check.gaps(params, c.config, items, "cpu", control=True)
    assert got["control_widest_gap"] > 3 * got["widest_gap"]


def test_pick_takes_the_longest_and_a_ridden_one():
    finished = [(10 + i, 50 + i, 5) for i in range(20)] + [(99, 10, 200)]
    chosen = check.pick(finished, {12}, 3, tokens=230, most=8)
    assert chosen[0] == 20 and chosen[1] == 2
    assert sum(finished[i][2] for i in chosen) >= 230
    assert chosen == check.pick(finished, {12}, 3, tokens=230, most=8)
    assert len(check.pick(finished, set(), 3, tokens=10**6, most=8)) == 8


def test_prompt_ids_are_the_executors():
    got = check.prompt_ids(1234567, 9, 512)
    want = np.random.default_rng(1234567).integers(0, 512, size=9)
    assert np.array_equal(got, want)
