"""PyTorch port, rwkv6: the plain WKV forms against the JAX package's and
its Pallas kernel in interpret mode, the ``wkv6_op`` routing and the
kernel wrapper's refusals, the init and the converter, teacher-forced
logits and state against the JAX model (f32 SMOKE, atol = rtol = 1e-4: the
same math summed in another order), and the executor's stateful path,
whose decode leaves slots outside the batch untouched."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.request import SLOSpec as JSLOSpec  # noqa: E402
from repro.kernels.wkv6 import wkv6_chunked  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro.serving.executor import \
    ClusterRealExecutors as JaxCluster  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wkv6 as twkv  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402

ARCH = "rwkv6-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_wkv6_kernel.py's tolerances for the chunked form against the
# scan (f32 out, state), and for the Pallas kernel's bf16 output
KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)
STATE_TOL = dict(rtol=3e-4, atol=3e-3)
BF16_OUT_TOL = dict(rtol=3e-2, atol=3e-2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _mk(seed, b, t, h, d=64, dtype=jnp.float32, state_scale=0.1):
    """tests/test_wkv6_kernel.py::_mk: the same values as jax arrays and as
    torch tensors (r, k, v, w in ``dtype``; u, s0 f32)."""
    rng = np.random.default_rng(seed)
    r = jnp.asarray(rng.normal(size=(b, t, h, d)), dtype)
    k = jnp.asarray(rng.normal(size=(b, t, h, d)), dtype)
    v = jnp.asarray(rng.normal(size=(b, t, h, d)), dtype)
    dlog = rng.normal(size=(b, t, h, d)) * 2 - 4
    w = jnp.exp(-jnp.exp(jnp.clip(jnp.asarray(dlog, jnp.float32),
                                  -20.0, 0.5))).astype(dtype)
    u = jnp.asarray(rng.normal(size=(h, d)) * 0.5, jnp.float32)
    s0 = jnp.asarray(rng.normal(size=(b, h, d, d)) * state_scale,
                     jnp.float32)
    jargs = (r, k, v, w, u, s0)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    targs = tuple(_t(a.astype(jnp.float32)).to(tdt) for a in (r, k, v, w)) \
        + (_t(u), _t(s0))
    return jargs, targs


# ------------------------------------------------------------ WKV forms

# tests/test_wkv6_kernel.py's SWEEP
SWEEP = [
    (1, 64, 1, 64, 64, jnp.float32),
    (2, 256, 3, 64, 64, jnp.float32),
    (2, 128, 2, 64, 32, jnp.float32),    # chunk 32
    (1, 128, 2, 64, 64, jnp.bfloat16),
]


@pytest.mark.parametrize("b,t,h,d,chunk,dtype", SWEEP)
def test_plain_wkv_matches_jax_and_the_pallas_kernel(b, t, h, d, chunk,
                                                     dtype):
    jargs, targs = _mk(7, b, t, h, d, dtype)
    o_scan, s_scan = trwkv.wkv_scan(*targs)
    jo, js = jrwkv.wkv_scan(*jargs)
    _close(o_scan, jo)
    _close(s_scan, js)
    o_chunk, s_chunk = trwkv.wkv_chunked(*targs, chunk=chunk)
    jo, js = jrwkv.wkv_chunked(*jargs, chunk=chunk)
    _close(o_chunk, jo)
    _close(s_chunk, js, STATE_TOL)
    # the chunked form against the scan, as the JAX package checks it
    _close(o_chunk, o_scan, KERNEL_TOL)
    _close(s_chunk, s_scan, STATE_TOL)
    # the Pallas kernel run as the JAX tests run it on the CPU
    po, ps = wkv6_chunked(*jargs, chunk=chunk, interpret=True)
    _close(o_chunk, po, BF16_OUT_TOL if dtype == jnp.bfloat16
           else KERNEL_TOL)
    _close(s_chunk, ps, STATE_TOL)


def test_plain_decode_matches_jax():
    jargs, targs = _mk(3, 2, 1, 3)
    jr, jk, jv, jw, ju, js0 = jargs
    jo, js = jrwkv.wkv_decode(jr[:, 0], jk[:, 0], jv[:, 0], jw[:, 0], ju, js0)
    r, k, v, w, u, s0 = targs
    o, s = trwkv.wkv_decode(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    _close(o, jo)
    _close(s, js)


def test_ragged_t_and_the_state_carried_across_calls():
    """T = 100 (no multiple of any chunk) against the JAX scan, and the
    recurrence split at T = 64 with the state carried across: the two calls
    the kernel's chunk loop makes, a full chunk then a ragged one."""
    jargs, targs = _mk(11, 2, 100, 2)
    o, s = ref.wkv6_ref(*targs, mode="chunked")        # T % 64 != 0: scan
    jo, js = jrwkv.wkv_scan(*jargs)
    _close(o, jo)
    _close(s, js)
    r, k, v, w, u, s0 = targs
    o1, s1 = trwkv.wkv_chunked(r[:, :64], k[:, :64], v[:, :64], w[:, :64],
                               u, s0)
    o2, s2 = trwkv.wkv_scan(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u,
                            s1)
    _close(torch.cat([o1, o2], dim=1), o, KERNEL_TOL)
    _close(s2, s, STATE_TOL)


def _tf32(x):
    """f32 to tf32 (10 mantissa bits) by masking off the low 13 bits, i.e.
    rounding toward zero, as the chunk kernel splits its operands."""
    return (x.float().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the chunk kernel's mma.sync computes it: each operand split
    into a tf32 big part and a tf32 remainder, big*small + small*big +
    big*big summed in f32."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return ab @ bsm + asm @ bb + ab @ bb


def _wkv_3xtf32_emulation(r, k, v, w, u, s0, chunk=64):
    """The arithmetic of ``wkv6_chunk_kernel`` in plain torch: the chunked
    form over 64-row chunks (the last one ragged), exponents relative to
    the cumulative decay at the chunk's midpoint row, the three products
    in 3xTF32. Returns (out (B, T, H, D), sT) in f32."""
    rf, kf, vf, wf = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, w))
    uf = u.float()[None, :, None, :]
    s = s0.float()
    outs = []
    for t0 in range(0, r.shape[1], chunk):
        rt, kt, vt = (x[:, :, t0:t0 + chunk] for x in (rf, kf, vf))
        lw = torch.log(wf[:, :, t0:t0 + chunk].clamp_min(1e-38))
        cl = rt.shape[2]
        cum = lw.cumsum(2)
        prev = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], 2)
        ref_ = cum[:, :, (cl - 1) // 2:(cl - 1) // 2 + 1]
        tot = cum[:, :, -1:]
        rd, rs = rt * torch.exp(prev - ref_), rt * torch.exp(prev)
        kj, ks = kt * torch.exp(ref_ - cum), kt * torch.exp(tot - cum)
        mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool), -1)
        att = torch.where(mask, _mm_3xtf32(rd, kj.transpose(-1, -2)), 0.0)
        diag = (rt * uf * kt).sum(-1, keepdim=True)
        outs.append(_mm_3xtf32(rs, s) + _mm_3xtf32(att, vt) + diag * vt)
        s = torch.exp(tot).transpose(-1, -2) * s + _mm_3xtf32(
            ks.transpose(-1, -2), vt)
    return torch.cat(outs, 2).permute(0, 2, 1, 3), s


@pytest.mark.parametrize("b,t,h,dtype,state_scale", [
    (1, 100, 2, jnp.float32, 0.1),       # ragged last chunk
    (2, 128, 2, jnp.float32, 0.1),
    (1, 65, 1, jnp.bfloat16, 0.1),       # one row past a chunk
    (1, 256, 1, jnp.float32, 1.0),
])
def test_3xtf32_chunk_numerics_match_jax_scan(b, t, h, dtype, state_scale):
    """The chunk kernel's tensor-core products (3xTF32) hold the JAX
    package's chunked-vs-scan tolerances against ``wkv_scan``."""
    jargs, targs = _mk(13, b, t, h, dtype=dtype, state_scale=state_scale)
    o, s = _wkv_3xtf32_emulation(*targs)
    jo, js = jrwkv.wkv_scan(*(a.astype(jnp.float32) for a in jargs))
    _close(o, jo, KERNEL_TOL)
    _close(s, js, STATE_TOL)


# ------------------------------------------------------------- routing


@pytest.mark.parametrize("mode,t,form", [("decode", 1, "wkv_decode"),
                                         ("chunked", 64, "wkv_chunked"),
                                         ("chunked", 128, "wkv_chunked"),
                                         ("chunked", 50, "wkv_scan"),
                                         ("chunked", 1, "wkv_scan")])
def test_wkv6_op_routes_cpu_tensors_to_the_jax_models_form(monkeypatch, mode,
                                                           t, form):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(twkv, "wkv6", no_kernel)
    called = []
    for name in ("wkv_decode", "wkv_chunked", "wkv_scan"):
        real = getattr(trwkv, name)
        monkeypatch.setattr(trwkv, name, lambda *a, _n=name, _r=real, **k:
                            (called.append(_n), _r(*a, **k))[1])
    jargs, targs = _mk(5, 2, t, 2)
    out, s = ops.wkv6_op(*targs, mode)
    assert called == [form]
    assert out.shape == targs[0].shape and out.dtype == torch.float32
    jo, js = jrwkv.wkv_scan(*jargs)
    _close(out, jo, KERNEL_TOL)
    _close(s, js, STATE_TOL)
    assert twkv.launches == 0


def test_wkv6_op_refuses_unknown_modes_and_devices():
    _, targs = _mk(5, 1, 2, 1)
    with pytest.raises(ValueError, match="mode"):
        ops.wkv6_op(*targs, "scan")
    with pytest.raises(ValueError, match="one token"):
        ops.wkv6_op(*targs, "decode")
    meta = torch.empty((1, 2, 1, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.wkv6_op(meta, *targs[1:], "chunked")


@pytest.mark.parametrize("bad", ["cpu", "half", "mixed", "w_bf16", "s0_bf16",
                                 "head_size"])
def test_wkv6_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The wrapper launches on CUDA or raises; it never runs on the CPU."""
    d = 32 if bad == "head_size" else 64
    r, k, v, w, u, s0 = (torch.zeros(2, 3, 2, d), torch.zeros(2, 3, 2, d),
                         torch.zeros(2, 3, 2, d), torch.zeros(2, 3, 2, d),
                         torch.zeros(2, d), torch.zeros(2, 2, d, d))
    match = {"cpu": "not CUDA", "half": "bf16 or f32", "mixed": "one dtype",
             "w_bf16": "f32", "s0_bf16": "f32", "head_size": "head size"}[bad]
    if bad == "half":
        r, k, v = (x.half() for x in (r, k, v))
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "w_bf16":
        w = w.bfloat16()
    elif bad == "s0_bf16":
        s0 = s0.bfloat16()
    with pytest.raises(ValueError, match=match):
        twkv.wkv6(r, k, v, w, u, s0)


# ------------------------------------------------------ init + converter


def _models(dtype=None):
    jcfg, tcfg = jax_smoke(ARCH), get_smoke(ARCH)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jp


def _node(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _torch_dtype(leaf):
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[np.asarray(leaf).dtype.name]


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_torch_init_matches_jax_tree_dtypes_and_scales(dtype):
    """Same tree, shapes and per-leaf dtypes as the JAX init (decay_base and
    bonus_u f32 in a bf16 model); a std within 10% of the JAX draw's on
    every leaf, and equal constants."""
    jcfg, tcfg, jm, tm, jp = _models(dtype)
    tp = tm.init(torch.Generator().manual_seed(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = _node(tp, path)
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == _torch_dtype(leaf), path
        jl = np.asarray(leaf, np.float32)
        js, ts = float(np.std(jl)), float(node.float().std())
        assert abs(ts - js) <= 0.1 * js + 1e-12, (path, ts, js)
        if js == 0:
            np.testing.assert_array_equal(node.float().numpy(), jl)
    tail = tp["blocks"]["tm"]
    assert tail["decay_base"].dtype == tail["bonus_u"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_converter_keeps_each_leafs_dtype_and_values(dtype):
    jcfg, tcfg, jm, tm, jp = _models(dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    n_f32 = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = _node(tp, path)
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == _torch_dtype(leaf), path
        n_f32 += node.dtype == torch.float32
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert n_f32 == (2 if dtype else len(jax.tree.leaves(jp)))


# ------------------------------------------------------- end-to-end logits


@pytest.mark.parametrize("t", [64, 50])        # chunked form, then the scan
def test_teacher_forced_logits_and_state_match_jax(t):
    jcfg, tcfg, jm, tm, jp = _models()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    b = 2
    toks = rng.integers(0, jcfg.vocab_size, size=(b, t)).astype(np.int32)
    lengths = np.array([t, t - 3], np.int32)
    jc, tc = jm.init_cache(b, 128), tm.init_cache(b, 128, "cpu")
    jl, jc = jm.prefill(jp, jc, toks, lengths)
    tl, tc = tm.prefill(tp, tc, torch.from_numpy(toks),
                        torch.from_numpy(lengths))
    _close(tl, jl)
    for name in jc:
        _close(tc[name], jc[name])
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode(jp, jc, tok, lengths)
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok),
                           torch.from_numpy(lengths))
        _close(tl, jl)
    for name in jc:
        _close(tc[name], jc[name])


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
    rwkv state of those two requests takes in one bogus token. The port
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


def test_slot_outside_the_decode_batch_keeps_its_state():
    port = _port_cluster(n=1)
    e = port.execs[0]
    a, b = (Request(rid=i, arrival_time=0.0, prompt_len=p, output_len=8,
                    slo=SLOSpec(ttft=30.0, tpot=5.0))
            for i, p in ((0, 20), (1, 12)))
    e.run_plan(_plan(IterationPlan, prefill=[(a, 20), (b, 12)]))
    a.prefilled_tokens, b.prefilled_tokens = 20, 12
    sa, sb = e.slot_of[0], e.slot_of[1]
    before = {k: v.clone() for k, v in e.cache.items()}
    e.run_plan(_plan(IterationPlan, decode=[a]))
    for k, v in e.cache.items():
        assert torch.equal(v[:, sb], before[k][:, sb]), k
        assert not torch.equal(v[:, sa], before[k][:, sa]), k
    assert len(e.generated[0]) == 2 and len(e.generated[1]) == 1


def test_warmup_runs_one_prefill_and_one_decode(monkeypatch):
    modes = []
    real = ops.wkv6_op
    monkeypatch.setattr(ops, "wkv6_op", lambda *a: (modes.append(a[-1]),
                                                    real(*a))[1])
    execs = ClusterRealExecutors(get_smoke(ARCH), 2, max_len=64, device="cpu")
    n = get_smoke(ARCH).num_layers
    assert modes == ["chunked"] * n + ["decode"] * n
    assert execs.kernels is None
    assert all(not v.any() for e in execs.execs.values()
               for v in e.cache.values()), "warmup touched a worker's state"
