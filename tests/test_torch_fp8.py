"""PyTorch port, the fp8 (e4m3) KV cache: the cast's bytes against JAX's
(overflow to NaN included), the plain attention with e4m3 K/V against the
JAX oracles on the same K/V widened in JAX, teacher-forced logits and
cache bytes of the dense model against the JAX model (deepseek-7b and
gemma2-2b SMOKE, f32), the executor's token streams against the JAX
executor's in both regimes (qwen2 SMOKE), and what the model API and the
kernel input checks accept."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.request import SLOSpec as JSLOSpec  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro.serving.executor import \
    ClusterRealExecutors as JaxCluster  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402

E4M3 = torch.float8_e4m3fn
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the plain attention, e4m3 K/V: the same f32 math as the JAX oracle in
# another summation order (f32), one rounding of the output (bf16)
ATTN_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# model logits with an fp8 cache: the f32 models' tolerance (the same math
# summed in another order), as every cache byte below equals JAX's
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# at least this share of the cache's bytes equals JAX's: a K/V value that
# f32 rounding in the two frameworks moves across an e4m3 rounding boundary
# may part by one e4m3 step (none did on these inputs: 1.0 for both)
MIN_BYTES_EQUAL = 0.99


def _fp8_cfg(get, arch):
    return dataclasses.replace(get(arch), kv_cache_quant=True)


def _e4m3_bytes_jax(x, dtype):
    j = jnp.asarray(x, JNP[dtype]).astype(jnp.float8_e4m3fn)
    return np.asarray(j).view(np.uint8)


# --------------------------------------------------------------- the cast


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e4m3_cast_bytes_equal_jax(dtype):
    """``layers.to_e4m3`` gives JAX's bytes on a seeded range with the
    edges: +-448 (the largest finite), +-464 (the last value that rounds
    to it), +-470 and +-1e4 and +-inf (NaN in JAX, +-448 in torch's own
    cast), the subnormals and below, NaN of both signs."""
    rng = np.random.default_rng(0)
    edges = [0.0, -0.0, 448.0, -448.0, 449.0, 463.9, 464.0, -464.0, 464.1,
             470.0, -470.0, 479.0, 480.0, 1e4, -1e4, np.inf, -np.inf,
             2.0 ** -9, -(2.0 ** -9), 2.0 ** -10, 3 * 2.0 ** -11,
             2.0 ** -7 * 1.0625, 2.0 ** -6, 1e-30, np.nan, -np.nan]
    x = np.concatenate([
        np.asarray(edges, np.float32),
        rng.normal(scale=3.0, size=4000).astype(np.float32),
        (rng.normal(size=2000) * 10.0 ** rng.uniform(-4, 3, 2000))
        .astype(np.float32),
        rng.uniform(-600, 600, 2000).astype(np.float32)])
    want = _e4m3_bytes_jax(x, dtype)
    # JAX's values bit for bit (torch's f32 -> bf16 cast drops a NaN's sign)
    bits = np.asarray(jnp.asarray(x, JNP[dtype]))
    bits = bits.view(np.int16 if dtype == "bfloat16" else np.int32).copy()
    t = torch.from_numpy(bits).view(TORCH[dtype])
    got = TL.to_e4m3(t).view(torch.uint8).numpy()
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, [(float(x[i]), hex(got[i]), hex(want[i]))
                           for i in bad[:8]]
    # torch's own cast saturates where JAX's gives NaN: the guard matters
    assert (t.to(E4M3).view(torch.uint8).numpy() != want).any()


def test_cache_write_stores_jax_bytes():
    """``_cache_write`` into an e4m3 cache stores the cast's bytes at the
    rows it names, and nothing else."""
    rng = np.random.default_rng(1)
    cache = torch.zeros((2, 10, 2, 8), dtype=E4M3)
    new = torch.from_numpy(rng.normal(scale=200.0, size=(2, 3, 2, 8))
                           .astype(np.float32))
    TL._cache_write(cache, new, torch.tensor([0, 6], dtype=torch.int32))
    got = cache.view(torch.uint8).numpy()
    want = _e4m3_bytes_jax(new.numpy(), "float32")
    np.testing.assert_array_equal(got[0, 0:3], want[0])
    np.testing.assert_array_equal(got[1, 6:9], want[1])
    assert not got[0, 3:].any() and not got[1, :6].any() \
        and not got[1, 9:].any()


# --------------------------------------------------- the plain attention


def _kv_pair(a, dtype):
    """e4m3 K or V: the torch tensor, and JAX's widening to q's dtype."""
    j8 = jnp.asarray(a, jnp.float32).astype(jnp.float8_e4m3fn)
    t8 = torch.from_numpy(np.asarray(j8).view(np.uint8).copy()).view(E4M3)
    return j8.astype(JNP[dtype]), t8


def _q_pair(a, dtype):
    j = jnp.asarray(a, JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 5)])
def test_plain_paged_attention_e4m3_matches_jax(dtype, softcap, window):
    rng = np.random.default_rng(2)
    b, hq, hkv, d, ps, mp = 3, 8, 2, 64, 16, 4
    n_pages = b * mp + 2
    jq, tq = _q_pair(rng.normal(size=(b, hq, d)), dtype)
    jk, tk = _kv_pair(rng.normal(size=(n_pages, ps, hkv, d)) * 3, dtype)
    jv, tv = _kv_pair(rng.normal(size=(n_pages, ps, hkv, d)) * 3, dtype)
    tables = rng.permutation(n_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    lengths = np.array([1, 30, 64], np.int32)
    want = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(tables),
                                    jnp.asarray(lengths), softcap=softcap)
    got = ref.paged_attention_ref(tq, tk, tv, torch.from_numpy(tables),
                                  torch.from_numpy(lengths), softcap=softcap)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **ATTN_TOL[dtype])
    if window is not None:      # the port's window against the same rows
        got_w = ref.paged_attention_ref(
            tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths),
            softcap=softcap, window=window)
        wide = ref.paged_attention_ref(
            tq, tk.to(TORCH[dtype]), tv.to(TORCH[dtype]),
            torch.from_numpy(tables), torch.from_numpy(lengths),
            softcap=softcap, window=window)
        assert torch.equal(got_w, wide)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, 8)])
def test_plain_chunked_prefill_e4m3_matches_jax(dtype, softcap, window):
    rng = np.random.default_rng(3)
    b, sq, hq, hkv, d, smax = 2, 12, 4, 2, 64, 40
    jq, tq = _q_pair(rng.normal(size=(b, sq, hq, d)), dtype)
    jk, tk = _kv_pair(rng.normal(size=(b, smax, hkv, d)) * 3, dtype)
    jv, tv = _kv_pair(rng.normal(size=(b, smax, hkv, d)) * 3, dtype)
    starts = np.array([0, 20], np.int32)
    want = jref.chunked_prefill_attention_ref(
        jq, jk, jv, jnp.asarray(starts), softcap=softcap, window=window)
    got = ref.chunked_prefill_attention_ref(
        tq, tk, tv, torch.from_numpy(starts), softcap=softcap, window=window)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **ATTN_TOL[dtype])


# ------------------------------------------------------------------ model


def _models(arch):
    jcfg, tcfg = _fp8_cfg(jax_smoke, arch), _fp8_cfg(get_smoke, arch)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jm, tm, jp, tp


def _bytes_equal(tc, jc) -> float:
    """The share of the caches' bytes that equal."""
    got = np.concatenate([tc[k].view(torch.uint8).numpy().ravel()
                          for k in ("k", "v")])
    want = np.concatenate([np.asarray(jc[k]).view(np.uint8).ravel()
                           for k in ("k", "v")])
    return float(np.mean(got == want))


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-2b"])
def test_fp8_cache_logits_and_bytes_match_jax(arch):
    """Teacher-forced prefill, a ``prefill_chunk`` with ``take`` and 6
    decode steps (gemma2: past its SMOKE window of 8, softcaps on) with an
    e4m3 cache: logits at ``LOGIT_TOL`` after every step, and the share of
    cache bytes equal to JAX's at least ``MIN_BYTES_EQUAL`` (printed)."""
    jcfg, jm, tm, jp, tp = _models(arch)
    rng = np.random.default_rng(0)
    b, max_len = 2, 48
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, 12)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)
    jc, tc = jm.init_cache(b, max_len), tm.init_cache(b, max_len, "cpu")
    assert tc["k"].dtype == E4M3 and jc["k"].dtype == jnp.float8_e4m3fn

    def close(tl, jl):
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl),
                                   **LOGIT_TOL)

    jl, jc = jm.prefill(jp, jc, prompt, lengths)
    tl, tc = tm.prefill(tp, tc, torch.from_numpy(prompt),
                        torch.from_numpy(lengths))
    close(tl, jl)
    chunk = rng.integers(0, jcfg.vocab_size, size=(b, 6)).astype(np.int32)
    take = np.array([6, 4], np.int32)
    jl, jc = jm.prefill_chunk(jp, jc, chunk, lengths, take=take)
    tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(chunk),
                              torch.from_numpy(lengths),
                              take=torch.from_numpy(take))
    close(tl, jl)
    pos = lengths + take
    for _ in range(6):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode(jp, jc, tok, pos)
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok.copy()),
                           torch.from_numpy(pos))
        close(tl, jl)
        pos = pos + 1
    share = _bytes_equal(tc, jc)
    print(f"{arch}: {share:.6f} of the e4m3 cache's bytes equal JAX's")
    assert share >= MIN_BYTES_EQUAL, share


# --------------------------------------------------------------- executor


def _plan(plan_cls, prefill=(), decode=()):
    pp = [(r, int(t)) for r, t in prefill]
    dr = list(decode)
    return plan_cls(
        decode_reqs=dr, prefill_parts=pp, n_decode=len(dr),
        sum_ctx=float(sum(r.prompt_len for r in dr)),
        prefill_tokens=int(sum(t for _, t in pp)),
        prefill_ctx_offset=0.0, exclusive_prefill=not dr)


def _drive(execs, mod, plan_cls):
    """One worker: a 20-token prompt of rid 3 in chunks of 12 and 8, then
    3 decodes; a second request (rid 1, 40 tokens) in one 2-row bucket
    beside the first chunk and decoding beside the first's decodes."""
    req_cls, slo_cls = mod
    e = execs.execs[0]
    a = req_cls(rid=3, arrival_time=0.0, prompt_len=20, output_len=8,
                slo=slo_cls(ttft=30.0, tpot=5.0))
    c = req_cls(rid=1, arrival_time=0.0, prompt_len=16, output_len=8,
                slo=slo_cls(ttft=30.0, tpot=5.0))
    for kw in (dict(prefill=[(a, 12), (c, 16)]), dict(prefill=[(a, 8)],
                                                      decode=[c]),
               dict(decode=[a, c]), dict(decode=[c, a]), dict(decode=[a])):
        plan = _plan(plan_cls, **kw)
        e.run_plan(plan)
        for r, t in plan.prefill_parts:
            r.prefilled_tokens += t
    return {3: list(e.generated[3]), 1: list(e.generated[1])}


@pytest.mark.parametrize("batched", [True, False])
def test_fp8_executor_token_streams_equal_jax(batched):
    """qwen2 SMOKE with an e4m3 cache, max_len 64: the JAX executor's
    streams in both regimes; rid 3's prompt in chunks of 12 + 8 then 3
    decodes gives [177, 335, 335, 335] there."""
    arch = "qwen2-1.5b"
    jax_execs = JaxCluster(_fp8_cfg(jax_smoke, arch), 1, max_slots=4,
                           max_len=64, batched=batched, warmup=False)
    want = _drive(jax_execs, (JRequest, JSLOSpec), JPlan)
    jp = japi.build(jax_smoke(arch)).init(jax.random.PRNGKey(0))
    tcfg = _fp8_cfg(get_smoke, arch)
    port = ClusterRealExecutors(
        tcfg, 1, max_slots=4, max_len=64, batched=batched, warmup=False,
        device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    got = _drive(port, (Request, SLOSpec), IterationPlan)
    assert port.execs[0].fast == batched
    assert port.execs[0].cache["k"].dtype == E4M3
    assert want[3] == [177, 335, 335, 335]
    assert got == want


# ------------------------------------------------------- what is accepted


def test_api_builds_fp8_and_refuses_the_ring():
    """The API builds the fp8 cache, and the fp8 ring (e4m3 rings beside
    e4m3 full-length layers); the executor refuses the ring."""
    for arch in ("qwen2-1.5b", "gemma2-2b"):
        api = tapi.build(_fp8_cfg(get_config, arch))
        cache = api.init_cache(1, 16, "cpu")
        assert cache["k"].dtype == cache["v"].dtype == E4M3
    ring = dataclasses.replace(_fp8_cfg(get_smoke, "gemma2-2b"),
                               window_sized_cache=True, scan_layers=False)
    cache = tapi.build(ring).init_cache(1, 16, "cpu")
    assert [(k.shape[1], k.dtype) for k in cache["k"]] == \
        [(8, E4M3), (16, E4M3)] * 2
    with pytest.raises(NotImplementedError, match="ring cache"):
        ClusterRealExecutors(ring, 1, max_len=16, warmup=False, device="cpu")


def test_kernel_checks_take_e4m3_kv_beside_bf16_or_f32_q():
    """K and V share one dtype, q's or e4m3; any other mix raises."""
    q = {dt: torch.zeros(2, 8, dtype=dt)
         for dt in (torch.bfloat16, torch.float32)}
    kv8 = torch.zeros(2, 8, dtype=E4M3)
    for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        assert build.check_cuda_inputs("k", (q[dt],), (), (kv8, kv8)) == code
        assert build.check_cuda_inputs("k", (q[dt],), (), (q[dt], q[dt])) \
            == code
    assert build.kv_code(kv8) == 1 and build.kv_code(q[torch.float32]) == 0
    bad = [(kv8, q[torch.bfloat16]), (q[torch.float32], q[torch.float32]),
           (torch.zeros(2, 8, dtype=torch.float8_e5m2),) * 2,
           (torch.zeros(2, 8, dtype=torch.float16),) * 2]
    for kv in bad:
        with pytest.raises(ValueError, match="K/V dtypes"):
            build.check_cuda_inputs("k", (q[torch.bfloat16],), (), kv)
    with pytest.raises(ValueError, match="bf16 or f32"):
        build.check_cuda_inputs("k", (kv8,), (), (kv8, kv8))
