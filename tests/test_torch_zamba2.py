"""PyTorch port, zamba2 (hybrid): the SSD forms, the causal conv and the
mamba2 block against the JAX package's, the init and the converter,
teacher-forced logits and the whole nested state against the JAX model
(f32 SMOKE, atol = rtol = 1e-4: the same math summed in another order),
the plain attention versions at zamba2's head_dim 80 (G = 1), and the
executor's stateful path over a nested state, whose decode leaves slots
outside the batch untouched."""
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
from repro.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro.kernels.paged_attention import paged_attention  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro.serving.executor import \
    ClusterRealExecutors as JaxCluster  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402
from repro_torch.models import zamba2 as TZ  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _node(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", k)]
    return tree


# -------------------------------------------------------------- SSD forms


def _ssd_inputs(seed, b=2, t=37, h=3, p=64, n=16):
    """x, dt (> 0, softplus of a normal), A (< 0), B, C, D and a non-zero
    s0, as numpy f32, and the same as jax arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, t, h, p)),
            np.log1p(np.exp(rng.normal(size=(b, t, h)) - 1.0)),
            -np.exp(rng.normal(size=(h,)) * 0.5),
            rng.normal(size=(b, t, n)), rng.normal(size=(b, t, n)),
            rng.normal(size=(h,)), rng.normal(size=(b, h, p, n)) * 0.5]
    arrs = [np.asarray(a, np.float32) for a in arrs]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                            for a in arrs]


@pytest.mark.parametrize("t", [1, 37, 64, 130])
def test_ssd_scan_matches_jax(t):
    """The port's scan (the chunked decomposition over a tail padded with
    dt = 0, x = B = C = 0) against JAX's sequential oracle, T a multiple of
    64 or not."""
    jargs, targs = _ssd_inputs(t, t=t)
    y, s = TM2.ssd_scan(*targs)
    jy, js = JM2.ssd_scan(*jargs)
    assert y.shape == (2, t, 3, 64) and s.shape == (2, 3, 64, 16)
    _close(y, jy)
    _close(s, js)


@pytest.mark.parametrize("t", [64, 128, 192])
def test_ssd_chunked_matches_jax(t):
    jargs, targs = _ssd_inputs(t + 1, t=t)
    y, s = TM2.ssd_chunked(*targs)
    jy, js = JM2.ssd_chunked(*jargs)
    _close(y, jy)
    _close(s, js)
    sy, ss = JM2.ssd_scan(*jargs)        # and the JAX scan, as JAX holds it
    _close(y, sy)
    _close(s, ss)


def test_ssd_decode_matches_jax():
    jargs, targs = _ssd_inputs(5, t=1)
    jx, jdt, jA, jB, jC, jD, js0 = jargs
    x, dt, A, Bm, Cm, D, s0 = targs
    y, s = TM2.ssd_decode(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, s0)
    jy, js = JM2.ssd_decode(jx[:, 0], jdt[:, 0], jA, jB[:, 0], jC[:, 0], jD,
                            js0)
    _close(y, jy)
    _close(s, js)


def test_ssd_scan_carries_the_state_across_calls():
    """T = 130 in one call equals 37 then 93 with the state carried (the
    padded rows of each call leave it unchanged)."""
    _, (x, dt, A, Bm, Cm, D, s0) = _ssd_inputs(9, t=130)
    y, s = TM2.ssd_scan(x, dt, A, Bm, Cm, D, s0)
    y1, s1 = TM2.ssd_scan(x[:, :37], dt[:, :37], A, Bm[:, :37], Cm[:, :37],
                          D, s0)
    y2, s2 = TM2.ssd_scan(x[:, 37:], dt[:, 37:], A, Bm[:, 37:], Cm[:, 37:],
                          D, s1)
    _close(torch.cat([y1, y2], dim=1), y.numpy())
    _close(s2, s.numpy())


# ------------------------------------------------------ conv + the block


def _models(dtype=None):
    jcfg, tcfg = jax_smoke(ARCH), get_smoke(ARCH)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jp


def _layer0(jp, tp):
    jl = jax.tree.map(lambda a: a[0], jp["blocks"])
    tl = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
              else v[0]) for k, v in tp["blocks"].items()}
    return jl, tl


def _block_state(cfg, b, seed):
    """A non-zero layer state, as numpy f32."""
    rng = np.random.default_rng(seed)
    d_inner, n_heads, _ = JM2.dims(cfg)
    k = cfg.ssm_conv - 1
    return {"conv_x": rng.normal(size=(b, k, d_inner)).astype(np.float32),
            "conv_bc": rng.normal(size=(b, k, 2 * cfg.ssm_state)).astype(
                np.float32),
            "ssd": (rng.normal(size=(b, n_heads, 64, cfg.ssm_state))
                    * 0.3).astype(np.float32)}


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    seq, state, w, bias = (rng.normal(size=s).astype(np.float32) for s in
                           ((2, 9, 12), (2, 3, 12), (4, 12), (12,)))
    out, new = TM2._causal_conv(*(torch.from_numpy(a)
                                  for a in (seq, state, w, bias)))
    jout, jnew = JM2._causal_conv(*(jnp.asarray(a)
                                    for a in (seq, state, w, bias)))
    _close(out, jout)
    _close(new, jnew)
    np.testing.assert_array_equal(new.numpy(), seq[:, -3:])


@pytest.mark.parametrize("seq_mode,t", [("chunked", 37), ("chunked", 64),
                                        ("decode", 1)])
def test_apply_block_matches_jax(seq_mode, t):
    """One mamba2 block of the SMOKE model from a non-zero state, in both
    sequence modes (the chunked mode at T = 37 takes the scan's function)."""
    jcfg, tcfg, jm, tm, jp = _models()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jl, tl = _layer0(jp, tp)
    x = np.random.default_rng(t).normal(size=(2, t, jcfg.d_model)).astype(
        np.float32)
    st = _block_state(jcfg, 2, t)
    out, new = TM2.apply_block(tl, torch.from_numpy(x),
                               {k: torch.from_numpy(v) for k, v in st.items()},
                               tcfg, seq_mode)
    jout, jnew = JM2.apply_block(jl, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in st.items()},
                                 jcfg, seq_mode)
    _close(out, jout)
    for k in jnew:
        _close(new[k], jnew[k])


# ------------------------------------------------------ init + converter


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_torch_init_matches_jax_tree_dtypes_and_scales(dtype):
    """Same tree, shapes and per-leaf dtypes as the JAX init (A_log,
    dt_bias and D f32 in a bf16 model); a std within 10% of the JAX draw's
    on every leaf, and equal constants."""
    jcfg, tcfg, jm, tm, jp = _models(dtype)
    tp = tm.init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(list(_leaves(tp)))
    for path, leaf in jflat:
        node = _node(tp, path)
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name
        jl = np.asarray(leaf, np.float32)
        js, ts = float(np.std(jl)), float(node.float().std())
        assert abs(ts - js) <= 0.1 * js + 1e-12, (path, ts, js)
        if js == 0:
            np.testing.assert_array_equal(node.float().numpy(), jl)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_converter_keeps_each_leafs_dtype_and_values(dtype):
    jcfg, tcfg, jm, tm, jp = _models(dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    n_f32 = 0
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = _node(tp, path)
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name
        n_f32 += node.dtype == torch.float32
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert n_f32 == (3 if dtype else len(jflat))
    assert set(tp) == {"embed", "blocks", "shared", "final_norm"}


def test_init_state_matches_jax_tree():
    jcfg, tcfg, jm, tm, _ = _models("bfloat16")
    js, ts = jm.init_cache(3, 32), tm.init_cache(3, 32, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(js)[0]
    assert len(jflat) == len(list(_leaves(ts))) == 5
    for path, leaf in jflat:
        node = _node(ts, path)
        assert tuple(node.shape) == leaf.shape and node.shape[1] == 3
        assert str(node.dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name
        assert not node.any()
    assert ts["k"].shape[0] == TZ.n_shared_invocations(tcfg) == 2


def test_full_config_builds():
    cfg = get_config(ARCH)
    api = tapi.build(cfg)
    assert api.cfg is cfg and api.prefill_chunk is None
    assert TZ.n_shared_invocations(cfg) == 9
    assert TM2.dims(cfg) == (5120, 80, 5248)


# ------------------------------------------------------- end-to-end logits


@pytest.mark.parametrize("t", [64, 50])     # SSD chunked, then the scan's
def test_teacher_forced_logits_and_state_match_jax(t):
    jcfg, tcfg, jm, tm, jp = _models()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    b = 2
    toks = rng.integers(0, jcfg.vocab_size, size=(b, t)).astype(np.int32)
    lengths = np.array([t, t - 3], np.int32)
    jc, tc = jm.init_cache(b, 96), tm.init_cache(b, 96, "cpu")
    jl, jc = jm.prefill(jp, jc, toks, lengths)
    tl, tc = tm.prefill(tp, tc, torch.from_numpy(toks),
                        torch.from_numpy(lengths))
    _close(tl, jl)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        _close(_node(tc, path), leaf)
    pos = lengths.copy()
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode(jp, jc, tok, pos)
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok),
                           torch.from_numpy(pos.copy()))
        _close(tl, jl)
        pos = pos + 1
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        _close(_node(tc, path), leaf)


# ----------------------------------- plain attention at head_dim 80, G = 1


def test_plain_attention_at_head_dim_80_matches_jax():
    """Both plain attention versions at zamba2's head geometry (Hq = Hkv,
    D = 80) against ``repro/kernels/ref.py`` and the Pallas kernels run in
    interpret mode, as the JAX tests run them on the CPU."""
    rng = np.random.default_rng(80)
    b, sq, h, d, smax, ps = 2, 32, 4, 80, 128, 16
    q, kc, vc = (rng.normal(size=s).astype(np.float32) for s in
                 ((b, sq, h, d), (b, smax, h, d), (b, smax, h, d)))
    starts = np.array([0, 96], np.int32)
    got = ref.chunked_prefill_attention_ref(
        *(torch.from_numpy(a) for a in (q, kc, vc, starts)))
    jargs = [jnp.asarray(a) for a in (q, kc, vc, starts)]
    _close(got, jref.chunked_prefill_attention_ref(*jargs))
    _close(got, chunked_prefill_attention(*jargs, bq=32, bk=64,
                                          interpret=True))
    qd = rng.normal(size=(b, h, d)).astype(np.float32)
    pages = [rng.normal(size=(b * smax // ps, ps, h, d)).astype(np.float32)
             for _ in range(2)]
    tables = rng.permutation(b * smax // ps).reshape(b, -1).astype(np.int32)
    lens = np.array([1, 77], np.int32)
    got = ref.paged_attention_ref(
        *(torch.from_numpy(a) for a in (qd, *pages, tables, lens)))
    jargs = [jnp.asarray(a) for a in (qd, *pages, tables, lens)]
    _close(got, jref.paged_attention_ref(*jargs))
    _close(got, paged_attention(*jargs, interpret=True))


# -------------------------------------------------------------- executor


def _plan(plan_cls, prefill=(), decode=()):
    pp = [(r, int(t)) for r, t in prefill]
    dr = list(decode)
    return plan_cls(
        decode_reqs=dr, prefill_parts=pp, n_decode=len(dr),
        sum_ctx=float(sum(r.prompt_len for r in dr)),
        prefill_tokens=int(sum(t for _, t in pp)),
        prefill_ctx_offset=0.0, exclusive_prefill=not dr)


def _drive(execs, mod, plan_cls, only=None):
    """tests/test_real_exec_fast.py::_drive; with ``only`` set, the same
    steps restricted to that one request (served alone)."""
    req_cls, slo_cls = mod
    slo = slo_cls(ttft=30.0, tpot=5.0)
    reqs = [req_cls(rid=i, arrival_time=0.0, prompt_len=p, output_len=8,
                    slo=slo) for i, p in enumerate((24, 40, 16, 33))]
    a, b, c, d = reqs
    e0, e1 = execs.execs[0], execs.execs[1]

    def keep(rs):
        return [r for r in rs if only is None or r.rid == only]

    def step(ex, prefill=(), decode=()):
        pre = [(r, t) for r, t in prefill if only is None or r.rid == only]
        plan = _plan(plan_cls, prefill=pre, decode=keep(decode))
        if not plan.prefill_parts and not plan.decode_reqs:
            return
        ex.run_plan(plan)
        for r, t in plan.prefill_parts:       # the engine's bookkeeping
            r.prefilled_tokens += t

    step(e0, prefill=[(a, 16)])
    step(e0, prefill=[(a, 8), (b, 24)])
    step(e0, prefill=[(b, 16)], decode=[a])   # b's final chunk rides on a's decode
    step(e1, prefill=[(d, 33)])
    step(e0, decode=[a, b])
    if keep([b]):
        execs.migrate(b, 0, 1)
    step(e0, prefill=[(c, 16)], decode=[a])   # c's final chunk rides on a's decode
    step(e1, decode=[b, d])
    step(e1, decode=[d, b])
    step(e0, decode=[c, a])
    owner = {0: e0, 1: e1, 2: e0, 3: e1}
    return {r.rid: list(owner[r.rid].generated[r.rid]) for r in keep(reqs)}


def _jax_cluster():
    return JaxCluster(jax_smoke(ARCH), 2, max_slots=4, max_len=64,
                      batched=False, warmup=False)


def _port_cluster(batched=True, n=2):
    jp = japi.build(jax_smoke(ARCH)).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), get_smoke(ARCH),
                             "cpu")
    return ClusterRealExecutors(get_smoke(ARCH), n, max_slots=4, max_len=64,
                                batched=batched, warmup=False, device="cpu",
                                params=params)


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX executor's streams on the whole drive, and for each request
    served alone."""
    together = _drive(_jax_cluster(), (JRequest, JSLOSpec), JPlan)
    alone = {}
    for rid in range(4):
        alone.update(_drive(_jax_cluster(), (JRequest, JSLOSpec), JPlan,
                            only=rid))
    return together, alone


@pytest.mark.parametrize("batched", [True, False])
def test_drive_streams_equal_each_request_served_alone(jax_streams, batched):
    """The port's streams equal the JAX executor serving each request
    alone, and the JAX executor's own drive for requests 0 and 3. The JAX
    executor's streams for requests 1 and 2 differ: their final prefill
    chunk rides on another request's decode batch, and the JAX scalar
    decode steps every slot (token 0 for slots outside the batch), so the
    mamba state of those two requests takes in one bogus token. The port
    decodes only the batch's slots."""
    together, alone = jax_streams
    port = _port_cluster(batched)
    got = _drive(port, (Request, SLOSpec), IterationPlan)
    assert not port.execs[0].fast and port.kernels is None
    assert got == alone
    assert got[0] == together[0] and got[3] == together[3]
    assert together[1] != alone[1] and together[2] != alone[2]
    for rid, toks in got.items():
        assert len(toks) >= 2, f"rid {rid} produced too few tokens"


def test_slot_outside_the_decode_batch_keeps_its_nested_state():
    """A decode of a alone leaves every leaf of b's slot, the nested mamba
    leaves and the shared block's K/V, bit for bit as it was, and moves
    a's."""
    port = _port_cluster(n=1)
    e = port.execs[0]
    a, b = (Request(rid=i, arrival_time=0.0, prompt_len=p, output_len=8,
                    slo=SLOSpec(ttft=30.0, tpot=5.0))
            for i, p in ((0, 20), (1, 12)))
    e.run_plan(_plan(IterationPlan, prefill=[(a, 20), (b, 12)]))
    a.prefilled_tokens, b.prefilled_tokens = 20, 12
    sa, sb = e.slot_of[0], e.slot_of[1]
    before = {p: v.clone() for p, v in _leaves(e.cache)}
    assert len(before) == 5
    e.run_plan(_plan(IterationPlan, decode=[a]))
    for path, v in _leaves(e.cache):
        assert torch.equal(v[:, sb], before[path][:, sb]), path
        assert not torch.equal(v[:, sa], before[path][:, sa]), path
    assert len(e.generated[0]) == 2 and len(e.generated[1]) == 1


def test_warmup_runs_one_prefill_and_one_decode():
    execs = ClusterRealExecutors(get_smoke(ARCH), 2, max_len=64, device="cpu")
    assert execs.kernels is None
    assert all(not v.any() for e in execs.execs.values()
               for _, v in _leaves(e.cache)), "warmup touched a worker's state"
