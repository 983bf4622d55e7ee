"""PyTorch port, gemma2's window-sized ring cache: decode from an empty
cache 20 tokens past the SMOKE window of 8 (``scan_layers=False``, as
``tests/test_perf_features.py::test_window_ring_cache_exact``), logits
against the JAX ring's and the port's full cache's (f32, rtol = atol =
2e-5, JAX's own tolerance: the ring holds its keys out of position order,
so the softmax sums run in another order), the same with an e4m3 cache, the
``max_len <= window`` case (no layer is a ring), the ring mask against the
kernel lengths the port gives the decode op, and what the port refuses: a
prefill over a ring (where JAX fails or attends wrongly) and the executor
over a ring (where JAX fails at the first step)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.request import SLOSpec as JSLOSpec  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro.serving.executor import \
    ClusterRealExecutors as JaxCluster  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402

ARCH = "gemma2-2b"
TOL = dict(rtol=2e-5, atol=2e-5)
# an e4m3 cache: test_torch_fp8.py's logit tolerance
FP8_TOL = dict(rtol=1e-4, atol=1e-4)
E4M3 = torch.float8_e4m3fn


def _cfgs(get, **changes):
    full = dataclasses.replace(get(ARCH), scan_layers=False, **changes)
    return full, dataclasses.replace(full, window_sized_cache=True)


def _params(jcfg, tcfg):
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _tokens(cfg, steps=20, batch=2):
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size, (batch, steps)).astype(np.int32)


def _decode_jax(cfg, params, toks, max_len):
    cache = JT.init_cache(cfg, toks.shape[0], max_len)
    lengths = jnp.zeros((toks.shape[0],), jnp.int32)
    outs = []
    for t in range(toks.shape[1]):
        out, cache = JT.decode(params, cache, toks[:, t], lengths, cfg)
        outs.append(np.asarray(out))
        lengths = lengths + 1
    return outs, cache


def _decode_port(cfg, params, toks, max_len):
    cache = TT.init_cache(cfg, toks.shape[0], max_len, "cpu")
    lengths = torch.zeros((toks.shape[0],), dtype=torch.int32)
    outs = []
    for t in range(toks.shape[1]):
        out, cache = TT.decode(params, cache, torch.from_numpy(toks[:, t]),
                               lengths, cfg)
        outs.append(out.numpy().copy())
        lengths = lengths + 1
    return outs, cache


@pytest.mark.parametrize("fp8", [False, True], ids=["f32", "e4m3"])
def test_ring_decode_matches_jax_ring_and_full_cache(fp8):
    """20 tokens past a window of 8 from an empty 40-token cache: every
    step's logits equal the JAX ring's and the port's full cache's; the
    rings are 8 slots, in e4m3 under ``kv_cache_quant``."""
    changes = dict(kv_cache_quant=True) if fp8 else {}
    jfull, jring = _cfgs(jax_smoke, **changes)
    tfull, tring = _cfgs(get_smoke, **changes)
    jp, tp = _params(jfull, tfull)
    toks = _tokens(tfull)
    want, _ = _decode_jax(jring, jp, toks, 40)
    got, cache = _decode_port(tring, tp, toks, 40)
    full, _ = _decode_port(tfull, tp, toks, 40)
    tol = FP8_TOL if fp8 else TOL
    for g, w, f in zip(got, want, full):
        np.testing.assert_allclose(g, w, **tol)
        np.testing.assert_allclose(g, f, **tol)
    assert [k.shape[1] for k in cache["k"]] == [8, 40, 8, 40]
    assert TT.ring_layers(cache) == [True, False, True, False]
    assert {k.dtype for k in cache["k"] + cache["v"]} == \
        {E4M3 if fp8 else torch.float32}


def test_ring_cache_bytes_match_jax_ring():
    """After 20 steps each ring holds the last 8 tokens' K/V at
    ``position mod 8``, as the JAX ring does."""
    jfull, jring = _cfgs(jax_smoke)
    tfull, tring = _cfgs(get_smoke)
    jp, tp = _params(jfull, tfull)
    toks = _tokens(tfull)
    _, jc = _decode_jax(jring, jp, toks, 40)
    _, tc = _decode_port(tring, tp, toks, 40)
    for name in ("k", "v"):
        for t, j in zip(tc[name], jc[name]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_max_len_within_the_window_keeps_the_windowed_mask():
    """``max_len`` 8 <= window 8: every layer's cache is 8 long, so none is
    a ring (JAX's ``kv[0].shape[1] < max_s``), and a prefill works there;
    logits equal JAX's."""
    jfull, jring = _cfgs(jax_smoke)
    tfull, tring = _cfgs(get_smoke)
    jp, tp = _params(jfull, tfull)
    toks = _tokens(tfull, steps=8)
    jc = JT.init_cache(jring, 2, 8)
    tc = TT.init_cache(tring, 2, 8, "cpu")
    assert isinstance(tc["k"], tuple) and not any(TT.ring_layers(tc))
    lengths = np.array([5, 3], np.int32)
    jl, jc = JT.prefill(jp, jc, toks[:, :5], lengths, jring)
    tl, tc = TT.prefill(tp, tc, torch.from_numpy(toks[:, :5]),
                        torch.from_numpy(lengths), tring)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = lengths.copy()
    for t in range(5, 8):
        tok = toks[:, t]
        jl, jc = JT.decode(jp, jc, tok, pos, jring)
        tl, tc = TT.decode(tp, tc, torch.from_numpy(tok), torch.from_numpy(
            pos), tring)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = np.minimum(pos + 1, 7)


@pytest.mark.parametrize("sk", [1, 8, 64])
def test_ring_mask_equals_the_kernel_lengths(sk):
    """JAX's ring rule ``kpos <= lengths | lengths + 1 >= Sk`` keeps the
    same slots as the port's kernel lengths ``min(lengths + 1, Sk)``, on
    every step up to and past the wrap."""
    lengths = np.arange(0, 3 * sk + 2, dtype=np.int32)
    want = np.asarray(JL.MaskSpec("ring").block(1, sk, 0, lengths))[:, 0, 0]
    n = np.minimum(lengths + 1, sk)
    got = np.arange(sk)[None] < n[:, None]
    np.testing.assert_array_equal(got, want)


def test_ring_decode_sends_clamped_lengths_and_no_window(monkeypatch):
    """Each ring layer's decode op gets its own 8-slot block table, kernel
    lengths ``min(lengths + 1, 8)`` and no window; the global layers the
    full cache's table and ``lengths + 1``."""
    _, tring = _cfgs(get_smoke)
    params = tapi.build(tring).init(torch.Generator().manual_seed(0))
    cache = TT.init_cache(tring, 2, 40, "cpu")
    calls = []
    real = ops.paged_attention_op

    def spy(q, kp, vp, tables, lengths, softcap=None, window=None):
        calls.append((kp.shape[0] * kp.shape[1] // q.shape[0],
                      tables.shape, lengths.tolist(), window))
        return real(q, kp, vp, tables, lengths, softcap=softcap,
                    window=window)

    monkeypatch.setattr(ops, "paged_attention_op", spy)
    lengths = torch.tensor([3, 25], dtype=torch.int32)
    TT.decode(params, cache, torch.tensor([1, 2], dtype=torch.int32),
              lengths, tring)
    assert calls == [(8, (2, 1), [4, 8], None), (40, (2, 5), [4, 26], None),
                     (8, (2, 1), [4, 8], None), (40, (2, 5), [4, 26], None)]


def test_prefill_over_a_ring_refused_where_jax_fails_or_attends_wrongly():
    """JAX's ``prefill`` over a ring fails; its ``prefill_chunk`` of 4
    tokens runs under the ring mask, so query i sees only ``kpos <=
    start``, and its logits part from the full cache's. The port refuses
    both entry points (a ring is decode-only)."""
    jfull, jring = _cfgs(jax_smoke)
    tfull, tring = _cfgs(get_smoke)
    jp, tp = _params(jfull, tfull)
    toks = _tokens(tfull, steps=4)
    zero = np.zeros(2, np.int32)
    with pytest.raises(TypeError):
        JT.prefill(jp, JT.init_cache(jring, 2, 40), toks,
                   np.array([4, 4], np.int32), jring)
    ring, _ = JT.prefill_chunk(jp, JT.init_cache(jring, 2, 40), toks, zero,
                               jring)
    full, _ = JT.prefill_chunk(jp, JT.init_cache(jfull, 2, 40), toks, zero,
                               jfull)
    assert float(jnp.abs(ring - full).max()) > 0.1
    port_full, _ = TT.prefill_chunk(tp, TT.init_cache(tfull, 2, 40, "cpu"),
                                    torch.from_numpy(toks),
                                    torch.from_numpy(zero), tfull)
    np.testing.assert_allclose(port_full.numpy(), np.asarray(full), **TOL)
    api = tapi.build(tring)
    cache = api.init_cache(2, 40, "cpu")
    with pytest.raises(ValueError, match="ring cache.*decode-only"):
        api.prefill(tp, cache, torch.from_numpy(toks),
                    torch.tensor([4, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="ring cache.*decode-only"):
        api.prefill_chunk(tp, cache, torch.from_numpy(toks),
                          torch.from_numpy(zero))


def test_executor_refuses_a_ring_where_jax_fails():
    """The JAX executor builds over a ring config but fails at its first
    prefill (its cache view slices the per-layer leaves' sequence axis);
    the port refuses the config when the cluster is built."""
    _, jring = _cfgs(jax_smoke)
    _, tring = _cfgs(get_smoke)
    jex = JaxCluster(jring, 1, max_slots=2, max_len=40, batched=False,
                     warmup=False)
    req = JRequest(rid=0, arrival_time=0.0, prompt_len=4, output_len=4,
                   slo=JSLOSpec(ttft=30.0, tpot=5.0))
    plan = JPlan(decode_reqs=[], prefill_parts=[(req, 4)], n_decode=0,
                 sum_ctx=0.0, prefill_tokens=4, prefill_ctx_offset=0.0,
                 exclusive_prefill=True)
    with pytest.raises(ValueError, match="inconsistent sizes"):
        jex.execs[0].run_plan(plan)
    for batched in (True, False):
        with pytest.raises(NotImplementedError, match="ring cache"):
            ClusterRealExecutors(tring, 1, max_slots=2, max_len=40,
                                 batched=batched, warmup=False, device="cpu")
