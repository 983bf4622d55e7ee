"""PyTorch port, gemma2: the SMOKE config (f32, 4 layers, sliding window 8
on the even layers, attention and final softcaps, GeGLU, sandwich
post-norms) from the JAX init through ``params_from_jax``. Teacher-forced
logits of ``prefill``, ``prefill_chunk`` with starts across the window and
20 decode steps past it against the JAX model (atol = rtol = 1e-4: the
same math summed in another order); the windowed decode attention against
the JAX XLA attention; the executor's token streams against the JAX
``RealExecutor``'s in both regimes; scheduling decisions under the
cost-model clock against the JAX simulator's."""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_executor import _drive  # noqa: E402
from test_torch_sched import _trace  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.request import SLOSpec as JSLOSpec  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving.costmodel import WorkerSpec as JWorkerSpec  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro.serving.executor import \
    ClusterRealExecutors as JaxCluster  # noqa: E402
from repro.serving.simulator import build_cluster as jbuild  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.perf import WorkerSpec  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402
from repro_torch.serving.simulator import build_cluster  # noqa: E402

ARCH = "gemma2-2b"
TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 8                      # SMOKE's sliding window


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_smoke(ARCH), get_smoke(ARCH)
    assert tcfg.sliding_window == WINDOW and tcfg.use_post_norms
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jm, tm, jp, tp


def test_init_and_converter_carry_the_post_norms(models):
    jcfg, jm, tm, jp, tp = models
    for name in ("norm_attn_post", "norm_mlp_post"):
        np.testing.assert_array_equal(
            tp["blocks"][name]["scale"].numpy(),
            np.asarray(jp["blocks"][name]["scale"]))
    mine = tm.init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = mine
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path


@pytest.mark.parametrize("chunks", [(12, 9), (5, 8, 11), (3, 13, 8)],
                         ids=lambda c: "-".join(map(str, c)))
def test_prefill_chunks_across_the_window_match_jax(models, chunks):
    """A 28-token prompt prefilled in chunks whose starts fall before,
    inside and past the window of 8; logits after every chunk."""
    jcfg, jm, tm, jp, tp = models
    rng = np.random.default_rng(sum(chunks))
    b, max_len = 2, 48
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, sum(chunks)))
    jc, tc = jm.init_cache(b, max_len), tm.init_cache(b, max_len, "cpu")
    start = 0
    for n in chunks:
        chunk = prompt[:, start:start + n].astype(np.int32)
        starts = np.full((b,), start, np.int32)
        jl, jc = jm.prefill_chunk(jp, jc, chunk, starts)
        tl, tc = tm.prefill_chunk(tp, tc, _t(chunk), _t(starts))
        _close(tl, jl)
        start += n
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_decode_20_steps_past_the_window_matches_jax(models):
    """prefill, a ``prefill_chunk`` with ``take`` whose rows start on both
    sides of the window, then 20 teacher-forced decode steps (positions up
    to 44, far past the window of 8)."""
    jcfg, jm, tm, jp, tp = models
    rng = np.random.default_rng(0)
    b, max_len = 2, 64
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, 12)).astype(np.int32)
    lengths = np.array([12, 5], np.int32)
    jc, tc = jm.init_cache(b, max_len), tm.init_cache(b, max_len, "cpu")
    jl, jc = jm.prefill(jp, jc, prompt, lengths)
    tl, tc = tm.prefill(tp, tc, _t(prompt), _t(lengths))
    _close(tl, jl)

    chunk = rng.integers(0, jcfg.vocab_size, size=(b, 10)).astype(np.int32)
    take = np.array([10, 7], np.int32)
    jl, jc = jm.prefill_chunk(jp, jc, chunk, lengths, take=take)
    tl, tc = tm.prefill_chunk(tp, tc, _t(chunk), _t(lengths), take=_t(take))
    _close(tl, jl)
    pos = lengths + take
    for _ in range(20):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode(jp, jc, tok, pos)
        tl, tc = tm.decode(tp, tc, _t(tok), _t(pos))
        _close(tl, jl)
        pos = pos + 1
    assert pos.min() > 3 * WINDOW
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("window", [None, 1, 5, 8, 40])
def test_windowed_decode_attention_matches_jax(models, window):
    """``apply_attention`` with ``MaskSpec("lengths", window)`` (the decode
    op's plain version on the CPU) against the JAX XLA attention, with
    write positions below, at and past the window."""
    jcfg, jm, tm, jp, tp = models
    tcfg = get_smoke(ARCH)
    jb = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tb = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    rng = np.random.default_rng(2)
    b, smax = 4, 32
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
    cache = rng.normal(size=(2, b, smax, jcfg.num_kv_heads,
                             jcfg.head_dim)).astype(np.float32)
    pos = np.array([0, 7, 8, 30], np.int32)
    kw = dict(positions=pos[:, None], kv_cache=(cache[0], cache[1]),
              cache_positions=pos, lengths=pos)
    jout, (jk, jv) = JL.apply_attention(
        jb, x, jcfg, mask=JL.MaskSpec("lengths", window=window), **kw)
    tk, tv = _t(cache[0]), _t(cache[1])
    tout, _ = TL.apply_attention(
        tb, _t(x), tcfg, positions=_t(pos[:, None]),
        mask=TL.MaskSpec("lengths", window=window), kv_cache=(tk, tv),
        cache_positions=_t(pos), lengths=_t(pos))
    _close(tout, jout)
    _close(tk, jk)


@pytest.mark.parametrize("batched", [True, False])
def test_executor_token_streams_equal_jax(batched):
    """tests/test_real_exec_fast.py::_drive's workload (prompts of 16-40
    tokens, past the window of 8): left-padded and 2-row buckets, mixed
    iterations, a migration."""
    jax_execs = JaxCluster(jax_smoke(ARCH), 2, max_slots=4, max_len=64,
                           batched=batched, warmup=False)
    want = _drive(jax_execs, (JRequest, JSLOSpec), JPlan)
    jp = japi.build(jax_smoke(ARCH)).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), get_smoke(ARCH),
                             "cpu")
    port = ClusterRealExecutors(get_smoke(ARCH), 2, max_slots=4, max_len=64,
                                batched=batched, warmup=False, device="cpu",
                                params=params)
    got = _drive(port, (Request, SLOSpec), IterationPlan)
    assert port.execs[0].fast == batched
    assert got == want
    assert all(len(toks) >= 2 for toks in got.values())


@pytest.mark.parametrize("policy", ["tropical", "distserve"])
def test_decisions_equal_jax_simulator(policy):
    sim_a, _ = jbuild(jax_smoke(ARCH), policy, n_workers=2,
                      worker_spec=JWorkerSpec(tp=1), record_decisions=True)
    sim_a.add_trace(_trace(JRequest, JSLOSpec, False, prompt=30))
    m_a = sim_a.run(until=3000.0)

    execs = ClusterRealExecutors(get_smoke(ARCH), 2, max_slots=8, max_len=64,
                                 device="cpu")
    backend = execs.as_backend(clock="model")
    sim_b, _ = build_cluster(get_smoke(ARCH), policy, n_workers=2,
                             worker_spec=WorkerSpec(tp=1),
                             record_decisions=True, backend=backend)
    trace = _trace(Request, SLOSpec, False, prompt=30)
    sim_b.add_trace(copy.deepcopy(trace))
    m_b = sim_b.run(until=3000.0)

    assert m_a.n_finished == m_b.n_finished == len(trace)
    assert sim_a.decisions and sim_a.decisions == sim_b.decisions
    assert m_a.row() == m_b.row()
    assert backend.iterations > 0


def test_cache_variants_raise_naming_the_roadmap():
    """Every cache variant builds: with ``scan_layers`` the uniform cache
    (as the JAX model keeps it), in the working dtype or fp8, and without
    it gemma2's ring cache (the JAX ``transformer._use_ring``), with or
    without fp8, whose local layers keep window-sized rings. The executor
    refuses the ring, naming ROADMAP.md (the JAX executor fails on it)."""
    full = get_config(ARCH)
    tapi.build(dataclasses.replace(full, window_sized_cache=True))
    tapi.build(dataclasses.replace(full, kv_cache_quant=True))
    smoke = get_smoke(ARCH)
    for ring in (dict(window_sized_cache=True, scan_layers=False),
                 dict(window_sized_cache=True, scan_layers=False,
                      kv_cache_quant=True)):
        tapi.build(dataclasses.replace(full, **ring))
        cfg = dataclasses.replace(smoke, **ring)
        cache = tapi.build(cfg).init_cache(2, 24, "cpu")
        assert [k.shape for k in cache["v"]] == \
            [(2, 8, 2, 16), (2, 24, 2, 16)] * 2
        with pytest.raises(NotImplementedError,
                           match=r"ring cache.*ROADMAP\.md"):
            ClusterRealExecutors(cfg, 1, max_len=24, warmup=False,
                                 device="cpu")
