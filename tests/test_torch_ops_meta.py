"""PyTorch port, the kernel ops' shape-only path (``kernels/ops.py``): all
meta inputs give a meta output of the op's shape and dtype with no plain
version run, and every call reports the dense count the JAX dry-run
records for the same shapes to the ``StepCost`` counters that are on. CPU
inputs still reach the plain versions; mixed devices raise."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.hloanalysis import StepCost  # noqa: E402

# (B, Sq, Hq, Hkv, D, Smax) prefill cases; (B, Hq, Hkv, D, pages, page)
# decode cases; (B, T, H, D, mode) WKV cases
PREFILL = [(2, 8, 4, 2, 16, 32), (1, 1024, 12, 2, 128, 1088),
           (4, 64, 8, 8, 80, 64)]
DECODE = [(3, 4, 2, 16, 4, 8), (8, 12, 2, 128, 17, 64), (2, 8, 1, 256, 2, 16)]
WKV = [(2, 1, 4, 64, "decode"), (1, 128, 2, 64, "chunked"),
       (2, 7, 2, 64, "chunked")]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def no_plain(monkeypatch):
    """Every plain version raises if called."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran for meta tensors")
    for name in ("paged_attention_ref", "chunked_prefill_attention_ref",
                 "wkv6_ref", "add_rms_norm_ref", "rope_cache_write_ref",
                 "gated_act_ref"):
        monkeypatch.setattr(ref, name, refuse)


@pytest.mark.parametrize("b,sq,hq,hkv,d,smax", PREFILL)
def test_chunked_prefill_meta(no_plain, b, sq, hq, hkv, d, smax):
    q = _meta(b, sq, hq, d)
    kv = _meta(b, smax, hkv, d)
    with StepCost() as cost:
        out = ops.chunked_prefill_op(q, kv, kv, _meta(b, dtype=torch.int32))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert cost.flops == 4.0 * b * hq * sq * smax * d
    assert cost.op_flops == {"chunked_prefill": cost.flops}
    assert cost.bytes == 2 * q.numel() * 2 + 2 * kv.numel() * 2
    assert cost.kernel_calls == [("chunked_prefill", tuple(q.shape),
                                  tuple(kv.shape), "torch.bfloat16",
                                  "torch.bfloat16")]


@pytest.mark.parametrize("b,hq,hkv,d,pages,ps", DECODE)
def test_paged_attention_meta(no_plain, b, hq, hkv, d, pages, ps):
    q = _meta(b, hq, d)
    kv = _meta(b * pages, ps, hkv, d, dtype=torch.float8_e4m3fn)
    tables = _meta(b, pages, dtype=torch.int32)
    with StepCost() as cost:
        out = ops.paged_attention_op(q, kv, kv, tables,
                                     _meta(b, dtype=torch.int32))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    sk = pages * ps
    assert cost.flops == 4.0 * b * hq * sk * d
    assert cost.bytes == 2 * q.numel() * 2 + 2.0 * b * sk * hkv * d \
        + tables.numel() * 4


@pytest.mark.parametrize("b,t,h,d,mode", WKV)
def test_wkv6_meta(no_plain, b, t, h, d, mode):
    r = _meta(b, t, h, d)
    s0 = _meta(b, h, d, d, dtype=torch.float32)
    with StepCost() as cost:
        out, s = ops.wkv6_op(r, r, r, r, _meta(h, d, dtype=torch.float32),
                             s0, mode)
    assert out.is_meta and out.shape == r.shape and out.dtype == torch.float32
    assert s.is_meta and s.shape == s0.shape and s.dtype == torch.float32
    if mode == "chunked" and t % 64 == 0:
        want = (t // 64) * 2.0 * b * h * (2 * 64 * d * d + 2 * 64 * 64 * d)
    else:
        want = 2.0 * b * h * d * d * t
    assert cost.flops == want


@pytest.mark.parametrize("rows,d,residual", [(16, 4096, True),
                                             (8192, 2304, False)])
def test_add_rms_norm_meta(no_plain, rows, d, residual):
    x = _meta(rows, 1, d)
    r = _meta(rows, 1, d) if residual else None
    with StepCost() as cost:
        total, out = ops.add_rms_norm_op(x, r, _meta(d), 1e-6)
    for t in (total, out):
        assert t.is_meta and t.shape == x.shape and t.dtype == x.dtype
    assert cost.flops == 0.0
    # x (and r) read, the norm (and the sum) written, the scale read
    assert cost.bytes == 2 * (x.numel() * (4 if residual else 2) + d)


@pytest.mark.parametrize("b,s,hq,hkv,d,cache", [
    (16, 1, 32, 32, 128, torch.bfloat16), (2, 512, 12, 2, 128, None),
    (8, 1, 8, 1, 256, torch.float8_e4m3fn)])
def test_rope_cache_write_meta(no_plain, b, s, hq, hkv, d, cache):
    q, k = _meta(b, s, hq, d), _meta(b, s, hkv, d)
    tables = _meta(b, s, 1, d // 2, dtype=torch.float32)
    kc = _meta(b, 1024, hkv, d, dtype=cache or torch.bfloat16)
    with StepCost() as cost:
        out = ops.rope_cache_write_op(q, k, k, tables, tables, kc, kc,
                                      _meta(b, dtype=torch.int32))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert cost.flops == 0.0
    assert cost.bytes == 2 * (2 * q.numel() + 2 * k.numel()) \
        + 2 * tables.numel() * 4 + b * 4 + 2 * k.numel() * kc.element_size()
    assert cost.kernel_calls[0][:3] == ("rope_cache_write", tuple(q.shape),
                                        tuple(kc.shape))


def test_gated_act_meta(no_plain):
    g = _meta(16, 1, 11008)
    with StepCost() as cost:
        out = ops.gated_act_op(g, g, "silu")
    assert out.is_meta and out.shape == g.shape and out.dtype == g.dtype
    assert cost.flops == 0.0 and cost.bytes == 3 * g.numel() * 2


def test_cpu_inputs_still_take_the_plain_versions_and_count():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 4, 16), generator=gen)
    kv = torch.randn((2, 8, 2, 16), generator=gen)
    starts = torch.tensor([0, 4], dtype=torch.int32)
    with StepCost() as cost:
        got = ops.chunked_prefill_op(q, kv, kv, starts)
    want = ref.chunked_prefill_attention_ref(q, kv, kv, starts)
    assert torch.equal(got, want)
    assert cost.op_flops["chunked_prefill"] == 4.0 * 2 * 4 * 4 * 8 * 16
    # nothing is counted when no StepCost is on
    ops.chunked_prefill_op(q, kv, kv, starts)
    assert cost.op_flops["chunked_prefill"] == 4.0 * 2 * 4 * 4 * 8 * 16


@pytest.mark.parametrize("op", ["prefill", "decode", "wkv6"])
def test_mixed_meta_and_cpu_inputs_raise(op):
    if op == "prefill":
        call = lambda: ops.chunked_prefill_op(  # noqa: E731
            _meta(1, 2, 2, 16), torch.zeros(1, 4, 2, 16),
            torch.zeros(1, 4, 2, 16), torch.zeros(1, dtype=torch.int32))
    elif op == "decode":
        call = lambda: ops.paged_attention_op(  # noqa: E731
            _meta(1, 2, 16), torch.zeros(1, 4, 2, 16),
            torch.zeros(1, 4, 2, 16), torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    else:
        r = torch.zeros(1, 1, 1, 64)
        call = lambda: ops.wkv6_op(  # noqa: E731
            r, r, r, _meta(1, 1, 1, 64), torch.zeros(1, 64),
            torch.zeros(1, 1, 64, 64), "decode")
    with pytest.raises(ValueError, match="no kernel for tensors on"):
        call()
